"""The facts the spiral and FitzHugh-Nagumo forwards (K2) rest on: each
spreads a chain's state over its threads, the spiral's one state
component a lane (csrc/spiral_field.cuh: SpiralDopri5Fwd), FitzHugh-
Nagumo's one trajectory point a thread (csrc/fhn_field.cuh: FHNPoint).

1. Both fields are pointwise: f at point n reads only that point and the
   chain's weights, so a thread may evaluate its own point (FHN), or every
   lane the gathered point (spiral), and get the per-chain evaluation's
   bits.  Held on the plain fields in float32: the FHN field at (C, N, 2)
   equals its N one-point evaluations bit for bit (it is elementwise); the
   plain spiral field within 1e-6 max-rel of them (its torch.matmul over
   the H units sums in another order at another N: measured 1.8e-7; the
   kernel's lanes sum each point's units in one order at every N); and
   the plain fields
   match the JAX package's fused-engine callbacks (`_spiral_factory`,
   `_fhn_factory`, over their packed (RP, C) planes) within 1e-5 max-rel,
   the gate of the port's float32 field-level parity (the rk4 kernels'
   plain versions against JAX).
2. The only chain-wide step of a spread forward is the error norm.  Each
   adapter gathers the chain's 2N ratios by shuffles and sums them as the
   per-chain loop of dopri5_common.cuh's step_decision does: the even
   components into sx and the odd into sy, each in ascending order.
   Emulated here in float32 on the ratios of one plain step: the ratios
   placed on lanes as each adapter places them (spiral: lane i holds
   component i, lanes past 2N mirror component 2N - 1; FHN: lane n of a
   chain holds its point's V and R, 32 // N chains a warp), gathered in
   the adapter's order, give every lane of the chain the per-chain loop's
   sums bit for bit; and the ratio is within 1e-6 of the plain
   `_step_decision`'s (torch's sums may take another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ops import fhn_dopri5 as jf
from bayesian_ode_tpu.ops import spiral_dopri5 as js
from bayesian_ode_tpu_torch.models import fhn_inference, spiral
from bayesian_ode_tpu_torch.ops import fused_adaptive as fa
from bayesian_ode_tpu_torch.ops import fused_field as ff
from bayesian_ode_tpu_torch.ops.fhn_dopri5 import fhn_field
from bayesian_ode_tpu_torch.ops.gp_dopri5 import _rk_stages, _step_decision
from bayesian_ode_tpu_torch.ops.spiral_dopri5 import spiral_field
from torch_parity import (  # noqa: F401
    fhn_theta,
    max_rel,
    one_torch_thread,
    spiral_params,
)

C = 64
F32 = np.float32
EPS = F32(2.0 ** -23)


def _states(points, seed):
    """(C, N, 2) float32 states around the fields' working range."""
    return torch.tensor(1.5 * np.random.RandomState(seed).randn(
        C, points, 2).astype(np.float32))


def _spiral(points):
    params = spiral_params(C=C, H=50, seed=points)
    t = spiral.params_from_numpy(params, dtype=torch.float32)
    return params, spiral_field(), tuple(t[k] for k in ("w1", "b1", "w2",
                                                         "b2"))


def _fhn(points):
    theta = fhn_theta(C=C, seed=points)
    t = fhn_inference.params_from_numpy(theta, dtype=torch.float32)
    return theta, fhn_field(), tuple(t[k] for k in "abc")


FIELDS = {"spiral": _spiral, "fhn": _fhn}
CASES = [("spiral", 5), ("spiral", 9), ("spiral", 16), ("fhn", 5),
         ("fhn", 40)]


@pytest.mark.parametrize("name,points", CASES)
def test_field_is_its_one_point_evaluations(name, points):
    _, field, w = FIELDS[name](points)
    y = _states(points, 1)
    rhs = field.make_rhs(w)
    f = rhs(y)
    assert f.dtype == torch.float32 and f.shape == y.shape
    for n in range(points):
        one = rhs(y[:, n:n + 1])
        if name == "fhn":
            assert torch.equal(one, f[:, n:n + 1]), n
        else:
            assert max_rel(one, f[:, n:n + 1]) <= 1e-6, n


@pytest.mark.parametrize("name,points", CASES)
def test_field_matches_the_jax_callbacks(name, points):
    """The JAX fused engine's rhs callback on its (RP, C) planes of x and
    y, RP the points padded to 8 (the padded rows read zero)."""
    params, field, w = FIELDS[name](points)
    y = _states(points, 2)
    RP = -(-points // 8) * 8
    if name == "spiral":
        rhs, _ = js._spiral_factory(points, RP)
        packed = js._pack_weights({k: jnp.asarray(v)
                                   for k, v in params.items()})
    else:
        rhs, _ = jf._fhn_factory(points, RP)
        packed = jf._pack_theta({k: jnp.asarray(v)
                                 for k, v in params.items()})
    planes = [np.concatenate([y[..., d].numpy().T,
                              np.zeros((RP - points, C), np.float32)])
              for d in (0, 1)]
    fx, fy = rhs(jnp.asarray(planes[0]), jnp.asarray(planes[1]), packed)
    want = np.stack([np.asarray(fx)[:points].T, np.asarray(fy)[:points].T],
                    axis=-1)
    assert not np.asarray(fx)[points:].any()
    assert max_rel(field.make_rhs(w)(y), want) <= 1e-5


def _step_ratios(name, points, method):
    """One plain step of the field from the Hairer start at rtol=1e-7 /
    atol=1e-9: the per-component ratios err / tol (C, 2N) in float32 as
    step_decision forms them, and the plain `_step_decision` ratio."""
    _, field, w = FIELDS[name](points)
    x0 = _states(points, 3)[0]
    rtol, atol = 1e-7, 1e-9
    x0b, f0, dt0 = ff._start(field, w, x0, rtol, atol)
    tableau = fa.TABLEAUS[method]
    k, y1 = _rk_stages(field.make_rhs(w), x0b, f0, dt0, tableau)
    _, ratio, _, _ = _step_decision(k, x0b, y1, dt0, rtol, atol, 0.9, 10.0,
                                    0.2, tableau=tableau)
    flat = [kk.reshape(C, -1).numpy() for kk in k]
    acc = None
    for c, kk in zip(tableau.c_error, flat):
        if c != 0:
            term = F32(c) * kk
            acc = term if acc is None else acc + term
    err = dt0.numpy()[:, None] * acc
    y0, y1 = x0b.reshape(C, -1).numpy(), y1.reshape(C, -1).numpy()
    mag = np.maximum(np.abs(y0), np.abs(y1))
    tol = np.maximum(F32(atol) + F32(rtol) * mag, (F32(32.0) * EPS) * mag)
    return err / tol, ratio.numpy()


def _chain_loop(r):
    """step_decision's per-chain loop: (sx, sy), each (C,) float32."""
    sx = np.zeros(r.shape[0], np.float32)
    sy = np.zeros(r.shape[0], np.float32)
    for i in range(r.shape[1]):
        if i % 2 == 0:
            sx = sx + r[:, i] * r[:, i]
        else:
            sy = sy + r[:, i] * r[:, i]
    return sx, sy


def _spiral_gather(r):
    """SpiralDopri5Fwd::norm_sums on every lane of each chain's warp:
    (32, C) sums; lane i holds ratio min(i, 2N - 1)."""
    ns = r.shape[1]
    lanes = [r[:, min(i, ns - 1)] for i in range(32)]
    sums = []
    for _ in range(32):                 # every lane gathers the same lanes
        sx = np.zeros(r.shape[0], np.float32)
        sy = np.zeros(r.shape[0], np.float32)
        for i in range(ns):
            ri = lanes[i]
            if i % 2 == 0:
                sx = sx + ri * ri
            else:
                sy = sy + ri * ri
        sums.append((sx, sy))
    return sums


def _point_gather(r, points):
    """FHNPoint::norm_sums on every lane of the warps: (lane's chain, sx,
    sy) for each lane that holds a point, chains in warps of 32 // N."""
    per_warp = 32 // points
    out = []
    for w0 in range(0, r.shape[0], per_warp):
        # lane l = j * N + n of the warp holds point n of chain w0 + j
        held = {j * points + n: (r[w0 + j, 2 * n], r[w0 + j, 2 * n + 1])
                for j in range(min(per_warp, r.shape[0] - w0))
                for n in range(points)}
        for lane in held:
            base = lane - lane % points
            sx, sy = F32(0.0), F32(0.0)
            for q in range(points):
                rx, ry = held[base + q]
                sx = F32(sx + rx * rx)
                sy = F32(sy + ry * ry)
            out.append((w0 + lane // points, sx, sy))
    return out


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
@pytest.mark.parametrize("name,points", CASES)
def test_gathered_norm_is_the_per_chain_loop(name, points, method):
    r, ratio = _step_ratios(name, points, method)
    assert r.dtype == np.float32 and np.isfinite(r).all() and r.any()
    sx, sy = _chain_loop(r)
    if name == "spiral":
        for gx, gy in _spiral_gather(r):
            assert np.array_equal(gx, sx) and np.array_equal(gy, sy)
    elif points <= 32:
        got = _point_gather(r, points)
        assert len(got) == C * points
        for c, gx, gy in got:
            assert gx == sx[c] and gy == sy[c], c
    # past 32 points a chain the forward keeps FHNDopri5: the loop itself
    ours = (sx + sy) / F32(2 * points)
    assert max_rel(ours, ratio) <= 1e-6
