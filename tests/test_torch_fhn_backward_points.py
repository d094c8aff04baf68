"""The fact FHN K3 rests on (csrc/fhn_field.cuh: FHNPoint runs the replay
backward one thread per trajectory point): with the step mesh frozen, the
reverse sweep of a chain's N points is the sum of N one-point sweeps.  The
FitzHugh-Nagumo field at point n reads only that point's V and R and the
chain's theta, so the points' adjoints never mix; they share only theta's
cotangent.

Held on the plain versions.  In float64, theta's cotangent of the whole
sweep against the sum of the one-point sweeps', and each point's x0
cotangent against its one-point sweep's, to 1e-12 max-rel: the same
arithmetic, with only the sum over points reassociated.  The one-point
sweeps slice each record's rows 2n and 2n + 1 and keep its t0 and dt.  In
float32, the one-point sweeps summed in ascending n (as the kernel's
acc_store sums them) against jax.grad through the JAX package's fused FHN
engine (interpret mode), at test_torch_fhn_dopri5.py's gate (1e-3 max-rel
of the parameters as one vector).  Last, acc_store's shuffle-down order,
emulated on a warp's lanes in float32: the chain's lane n = 0 ends with
the ascending sum of its N lanes' shares, bit for bit, at every N a warp
holds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ops import fhn_dopri5 as jf
from bayesian_ode_tpu_torch.ops import fused_adaptive as fa
from bayesian_ode_tpu_torch.ops import fused_field as ff
from bayesian_ode_tpu_torch.ops.fhn_dopri5 import fhn_field
from torch_parity import (  # noqa: F401
    FIELD_T,
    FIELD_X0,
    fhn_theta,
    field_outputs,
    max_rel,
    one_torch_thread,
    tree_max_rel,
)

f64 = torch.float64
TOL = {"rtol": 1e-5, "atol": 1e-7}


def _x0(points):
    if points == FIELD_X0.shape[0]:
        return torch.tensor(FIELD_X0)
    return torch.tensor(1.2 * np.random.RandomState(points).randn(
        points, 2).astype(np.float32))


def _records(points, method):
    """theta (a, b, c) as float32 tensors and the records and accepted
    counts of the plain float32 forward (the mesh is frozen, so any
    records do)."""
    theta = fhn_theta()
    w = tuple(torch.tensor(theta[k]) for k in "abc")
    field = fhn_field()
    ts = torch.tensor(FIELD_T)
    x0b, f0, dt0 = ff._start(field, w, _x0(points), TOL["rtol"], TOL["atol"])
    _, _, nacc, _, _, rec = fa.fwd_plain(
        field.make_rhs(w), x0b, f0, dt0, ts, TOL["rtol"], TOL["atol"], 0.9,
        10.0, 0.2, 100_000, "i", store_steps=128,
        tableau=fa.TABLEAUS[method])
    return w, ts, rec, nacc


def _point_sweeps(w, ts, rec, nacc, g, method):
    """Each point's one-point sweep: ([theta cotangents of point n], [its
    x0 cotangent (C, 1, 2)]), n ascending."""
    field = fhn_field()
    rhs, vjp = field.make_rhs(w), field.make_rhs_vjp(w)
    NS = rec.shape[1] - 2
    wbars, lbars = [], []
    for n in range(NS // 2):
        rows = rec[:, [2 * n, 2 * n + 1, NS, NS + 1], :]
        wb, lb = fa.bwd_plain(rhs, vjp, w, ts, rows, nacc, g[:, :, n:n + 1],
                              fa.TABLEAUS[method])
        wbars.append(wb)
        lbars.append(lb)
    return wbars, lbars


def _ascending(parts):
    """The sum of each leaf's shares in ascending n."""
    return tuple(sum((p[i] for p in parts[1:]), parts[0][i])
                 for i in range(len(parts[0])))


@pytest.mark.parametrize("points", [3, 5])
@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_replay_sweep_is_the_sum_of_one_point_sweeps_f64(points, method):
    w, ts, rec, nacc = _records(points, method)
    w64, rec64 = tuple(x.to(f64) for x in w), rec.to(f64)
    field = fhn_field()
    g = torch.tensor(np.random.RandomState(9).randn(
        ts.shape[0], w[0].shape[0], points, 2))
    wbar, lbar = fa.bwd_plain(field.make_rhs(w64), field.make_rhs_vjp(w64),
                              w64, ts, rec64, nacc, g, fa.TABLEAUS[method])
    wbars, lbars = _point_sweeps(w64, ts, rec64, nacc, g, method)
    for n, lb in enumerate(lbars):
        assert lb.shape == (w[0].shape[0], 1, 2)
        assert max_rel(lb[:, 0], lbar[:, n]) <= 1e-12, n
    for got, want in zip(_ascending(wbars), wbar):
        assert bool(want.any()) and max_rel(got, want) <= 1e-12


def test_one_point_sweeps_match_the_jax_engine():
    """The float32 one-point sweeps, summed in ascending n, against
    jax.grad of sum(ys * W) through the JAX package's fused FHN engine."""
    theta = fhn_theta()
    W, _ = field_outputs()
    jt = {k: jnp.asarray(v) for k, v in theta.items()}
    x0, ts = jnp.asarray(FIELD_X0), jnp.asarray(FIELD_T)
    grad = jax.grad(lambda p: jnp.sum(jf.fhn_dopri5_trajectory(
        p, x0, ts, interpret=True, **TOL) * W))(jt)
    w, tts, rec, nacc = _records(FIELD_X0.shape[0], "dopri5")
    wbars, _ = _point_sweeps(w, tts, rec, nacc, torch.tensor(W), "dopri5")
    got = dict(zip("abc", _ascending(wbars)))
    assert all(x.dtype == torch.float32 for x in got.values())
    assert tree_max_rel(got, grad) <= 1e-3


def _shfl_down(v, q):
    """__shfl_down_sync(kFull, v, q) over a warp's 32 lanes: lane l reads
    lane l + q, or its own value past lane 31."""
    src = np.arange(32) + q
    return v[np.where(src < 32, src, np.arange(32))]


@pytest.mark.parametrize("points", [1, 3, 5, 7, 16, 32])
def test_acc_store_adds_a_chains_lanes_in_ascending_order(points):
    """FHNPoint::acc_store on one warp: 32 // N chains of N lanes, each
    lane's share of a, b and c (idle lanes past the last chain hold
    values too; they write nothing).  s = v; s += shfl_down(v, q) for
    q = 1 .. N - 1, in float32: lane n = 0 of each chain holds its N
    shares' ascending sum bit for bit, within 1e-6 of torch's sum."""
    rng = np.random.RandomState(points)
    chains = 32 // points
    for _ in range(3):                      # theta's three leaves
        v = rng.randn(32).astype(np.float32) * np.float32(
            10.0) ** rng.randint(-3, 4, 32).astype(np.float32)
        s = v.copy()
        for q in range(1, points):
            s = (s + _shfl_down(v, q)).astype(np.float32)
        for c in range(chains):
            lanes = v[c * points:(c + 1) * points]
            want = np.float32(lanes[0])
            for x in lanes[1:]:
                want = np.float32(want + x)
            assert s[c * points] == want, (c, s[c * points], want)
            plain = float(torch.tensor(lanes).sum())
            assert abs(float(want) - plain) <= 1e-6 * np.abs(lanes).sum()
