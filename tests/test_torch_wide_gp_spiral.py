"""The GP and spiral fields at the shapes whose card kernels are the wide
ones (csrc/gp_wide_field.cuh, csrc/spiral_wide_field.cuh): the port's
plain versions, which those kernels are held to on the card, against the
JAX package on the CPU, its Pallas kernels in interpret mode, on one torch
thread.

GP: N = 40 trajectories on a 6 x 6 grid (two warps a chain: every GP
kernel wide) and N = 5 on a 15 x 15 grid (K3 and K5 wide, their Abar
columns past a block's shared memory in GPPoint), ell = 0.3 there (at
0.75 the 225-point kernel matrix is not positive definite in float64).
Spiral: (N, H) = (20, 40) (two components a lane) and (16, 128) (one warp's
stage buffer past 48 KB), on the JAX package's N = 9 case's lines and
times.  Every JAX kernel runs on 128 lanes whatever the chain count, so
the GP problems hold 4 chains (128 for the rk4 pair and the per-step
solver, which take whole tiles) at T = 8 output times.

Gates, those of the narrow shapes' files: the whole and per-step solves as
test_torch_gp_dopri5.py and test_torch_gp_dopri5_step.py (trajectories
within 1e-4 * max|y|, step counts by `check_solve`), the replay gradient
within 1e-3 max-rel of jax.grad through the JAX kernels (the JAX package's
float32 gate; test_torch_slice.py), the rk4 pair within 1e-5 (max|y|, and
max-rel of both cotangents; test_torch_gp_rk4.py), the spiral as
test_torch_spiral_dopri5.py (`check_solve`; the replay gradient within
1e-3 by `tree_max_rel`, and within 1e-5 of autograd through the plain
forward on its own step mesh).  The spiral's solves are 4-5 steps, and a
step whose error ratio lands within its rounding of 1 is accepted by one
package and rejected by the other: at (16, 128) one chain of four takes a
rejection in JAX that the port does not (its gradient is then that of
another step mesh, 1.06e-3 from JAX's by `tree_max_rel`).  So the
gradient is held to JAX's on the chains whose step counts equal JAX's,
and at most one chain may differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ops import gp_dopri5 as jg
from bayesian_ode_tpu.ops import spiral_dopri5 as js
from bayesian_ode_tpu.ops.gp_dopri5_grad import (
    gp_dopri5_trajectory as jtrajectory,
)
from bayesian_ode_tpu.ops.gp_rk4 import gp_rk4_trajectory as jrk4
from bayesian_ode_tpu_torch.models import spiral
from bayesian_ode_tpu_torch.ops import _build
from bayesian_ode_tpu_torch.ops import gp_dopri5 as tg
from bayesian_ode_tpu_torch.ops import gp_rk4 as tr
from bayesian_ode_tpu_torch.ops import spiral_dopri5 as ts_
from bayesian_ode_tpu_torch.ops.fused_field import (
    fused_dopri5_trajectory_plain,
)
from bayesian_ode_tpu_torch.ops.gp_dopri5_grad import gp_dopri5_trajectory
from torch_parity import (  # noqa: F401
    check_solve,
    gp_problem,
    max_rel,
    one_torch_thread,
    spiral_params,
    to_np,
    tree_max_rel,
)

# (N, grid side, ell) of each GP case
GP_CASES = {"n40": (40, 6, 0.75), "m225": (5, 15, 0.3)}
T8, T_MAX = 8, 2.0


def _gp(key, C):
    N, side, ell = GP_CASES[key]
    return gp_problem(C=C, T=T8, t_max=T_MAX, N=N, M=side, ell=ell)


@pytest.fixture(scope="module", params=sorted(GP_CASES))
def gp(request):
    return request.param, _gp(request.param, 4)


@pytest.fixture(scope="module", params=sorted(GP_CASES))
def gp128(request):
    """The rk4 and per-step JAX kernels take whole 128-chain tiles."""
    return request.param, _gp(request.param, 128)


def test_the_cases_take_the_wide_kernels():
    """N = 40: every GP kernel on GPWidePoint; 15 x 15 at N = 5: K3 and K5
    (their GPPoint blocks pass 232,448 B), the forwards on GPPoint; the
    spiral cases past one component a lane or 48 KB."""
    assert all(_build.gp_block((40, 36), R, acc).wide
               for R, acc in ((8, False), (8, True), (12, True)))
    assert not _build.gp_block((5, 225), 8, False).wide
    assert _build.gp_block((5, 225), 8, True).wide
    assert _build.gp_block((5, 225), 12, True).wide
    assert all(_build.spiral_wide(s) for s in SPIRAL_CASES)
    for family in ("gp_dopri5", "gp_rk4", "gp_dopri5_step"):
        for N, side, _ in GP_CASES.values():
            _build.check_shape(family, (N, side * side))
    for shape in SPIRAL_CASES:
        _build.check_shape("spiral_dopri5", shape)


def _gp_tensors(p):
    return (torch.tensor(p["A"]), torch.tensor(p["x0"]),
            torch.tensor(p["t"]))


def test_gp_whole_solve_matches_jax(gp):
    _, p = gp
    ys_j, st_j = jg.gp_dopri5_solve_whole(
        jnp.asarray(p["A"]), jnp.asarray(p["x0"]), jnp.asarray(p["t"]),
        p["jstatic32"], tile=128, interpret=True)
    A, x0, ts = _gp_tensors(p)
    ys, st = tg.gp_dopri5_solve_whole(A, x0, ts, p["tstatic"])
    check_solve(ys, st, ys_j, st_j)
    assert st["reached_final_time"] and bool(st_j["reached_final_time"])


def test_gp_replay_gradient_matches_jax(gp):
    _, p = gp
    A, x0, ts = _gp_tensors(p)
    W = np.random.RandomState(3).randn(T8, *p["A"].shape[:1],
                                       *p["x0"].shape).astype(np.float32)
    jA, jx0 = jax.grad(lambda a, x: jnp.sum(jtrajectory(
        a, x, jnp.asarray(p["t"]), p["jstatic32"], tile=128,
        interpret=True) * W), argnums=(0, 1))(jnp.asarray(p["A"]),
                                              jnp.asarray(p["x0"]))
    A.requires_grad_(True)
    x0.requires_grad_(True)
    (gp_dopri5_trajectory(A, x0, ts, p["tstatic"])
     * torch.tensor(W)).sum().backward()
    assert max_rel(A.grad, jA) <= 1e-3
    assert max_rel(x0.grad, jx0) <= 1e-3


def test_gp_rk4_pair_matches_jax(gp128):
    _, p = gp128
    ys_j, vjp = jax.vjp(lambda a, x: jrk4(a, x, jnp.asarray(p["t"]),
                                          p["jstatic32"], tile=128,
                                          interpret=True),
                        jnp.asarray(p["A"]), jnp.asarray(p["x0"]))
    g = np.random.RandomState(5).randn(*ys_j.shape).astype(np.float32)
    Abar_j, x0bar_j = vjp(jnp.asarray(g))
    A, x0, ts = _gp_tensors(p)
    s = p["tstatic"]
    Z, dts = s.Z.to(torch.float32), torch.diff(ts)
    ys = tr.gp_rk4_fwd_plain(A, Z, x0, dts, s.sf, s.ell)
    ys_j = np.asarray(ys_j)
    assert np.max(np.abs(to_np(ys) - ys_j)) <= 1e-5 * np.max(np.abs(ys_j))
    Abar, lbar = tr.gp_rk4_bwd_plain(A, Z, ys, torch.tensor(g), dts, s.sf,
                                     s.ell)
    assert max_rel(Abar, Abar_j) <= 1e-5
    assert max_rel(lbar.sum(dim=0), x0bar_j) <= 1e-5


def test_gp_per_step_solver_matches_jax(gp128):
    """K9's plain version against the JAX per-step solver, and against the
    port's whole solve: the same steps on every chain, as K9 is held to K1
    on the card."""
    _, p = gp128
    ys_j, st_j = jg.gp_dopri5_solve(jnp.asarray(p["A"]), jnp.asarray(p["x0"]),
                                    jnp.asarray(p["t"]), p["jstatic32"],
                                    interpret=True)
    A, x0, ts = _gp_tensors(p)
    ys, st = tg.gp_dopri5_solve(A, x0, ts, p["tstatic"])
    check_solve(ys, st, ys_j, st_j)
    ys1, st1 = tg.gp_dopri5_solve_whole(A, x0, ts, p["tstatic"])
    for k in ("nfe", "n_accepted", "n_rejected"):
        assert torch.equal(st[k], st1[k]), k
    assert float((ys - ys1).abs().max()) <= 5e-6


SPIRAL_CASES = [(20, 40), (16, 128)]
KEYS = ("w1", "b1", "w2", "b2")
SPIRAL_TOL = {"rtol": 1e-5, "atol": 1e-7}
C4, T6 = 4, 6


@pytest.fixture(scope="module", params=SPIRAL_CASES, ids=str)
def spiral_ref(request):
    """The JAX engine's solve and replay gradient on the N = 9 case's lines
    and times at (N, H)."""
    N, H = request.param
    params = spiral_params(C=C4, H=H, seed=N)
    x0 = np.stack([np.linspace(-1.5, 2.0, N),
                   np.linspace(0.8, -0.9, N)], axis=-1).astype(np.float32)
    ts = np.linspace(0.0, 1.2, T6).astype(np.float32)
    W = np.random.RandomState(H).randn(T6, C4, N, 2).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ys, st = js.spiral_dopri5_solve_stats(jp, jnp.asarray(x0),
                                          jnp.asarray(ts), interpret=True,
                                          **SPIRAL_TOL)
    grad = jax.grad(lambda q: jnp.sum(js.spiral_dopri5_trajectory(
        q, jnp.asarray(x0), jnp.asarray(ts), interpret=True,
        **SPIRAL_TOL) * W))(jp)
    return {"params": params, "x0": x0, "ts": ts, "W": W, "ys": ys,
            "st": st, "grad": grad}


def _spiral_params(ref):
    return {k: v.requires_grad_(True) for k, v in
            spiral.params_from_numpy(ref["params"]).items()}


def test_spiral_forward_matches_jax(spiral_ref):
    ref = spiral_ref
    ys, st = ts_.spiral_dopri5_solve_stats(
        _spiral_params(ref), torch.tensor(ref["x0"]),
        torch.tensor(ref["ts"]), **SPIRAL_TOL)
    check_solve(ys, st, ref["ys"], ref["st"])


def test_spiral_replay_gradient_matches_jax(spiral_ref):
    ref = spiral_ref
    x0, ts = torch.tensor(ref["x0"]), torch.tensor(ref["ts"])
    W = torch.tensor(ref["W"])
    params = _spiral_params(ref)
    ys = ts_.spiral_dopri5_trajectory(params, x0, ts, **SPIRAL_TOL)
    (ys * W).sum().backward()
    grad = {k: v.grad for k, v in params.items()}
    _, st = ts_.spiral_dopri5_solve_stats(params, x0, ts, **SPIRAL_TOL)
    same = np.ones(C4, bool)
    for k in ("n_accepted", "n_rejected"):
        same &= to_np(st[k]).astype(int) == np.asarray(ref["st"][k]).astype(
            int)
    assert same.sum() >= C4 - 1
    assert tree_max_rel({k: v[same] for k, v in grad.items()},
                        {k: np.asarray(v)[same]
                         for k, v in ref["grad"].items()}) <= 1e-3
    auto = _spiral_params(ref)
    (fused_dopri5_trajectory_plain(
        ts_.spiral_field(), tuple(auto[k] for k in KEYS), x0, ts,
        **SPIRAL_TOL) * W).sum().backward()
    assert tree_max_rel(grad, {k: v.grad for k, v in auto.items()}) <= 1e-5
