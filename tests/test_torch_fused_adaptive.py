"""Parity of the port's recording forward (plain K2) and replay backward
(plain K3) with the JAX package's fused dopri5 adjoint.

Gradient gate: max-rel <= 1e-3, the JAX package's float32 gate for its own
fused adjoint (tests/test_pallas_ops.py): both sides are float32 at the
noise floor (2-3e-4 apart there), and the step meshes of two float32
solves differ at rtol=1e-7 (see test_torch_gp_dopri5.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ops.gp_dopri5_grad import (
    gp_dopri5_trajectory as jax_trajectory,
)
from bayesian_ode_tpu_torch.ops import fused_adaptive as fa
from bayesian_ode_tpu_torch.ops import gp_dopri5 as tg
from bayesian_ode_tpu_torch.ops.gp_dopri5_grad import (
    gp_dopri5_trajectory,
    gp_dopri5_trajectory_plain,
)
from bayesian_ode_tpu_torch.ops.gp_field import gp_field
from torch_parity import (  # noqa: F401
    gp_problem,
    max_rel,
    one_torch_thread,
    to_np,
)


@pytest.fixture(scope="module")
def problem():
    p = gp_problem()
    T, C = p["t"].shape[0], p["A"].shape[0]
    p["W"] = np.random.RandomState(5).randn(T, C, 5, 2).astype(np.float32)
    return p


def _inputs(p):
    return (torch.tensor(p["A"]), torch.tensor(p["x0"]),
            torch.tensor(p["t"]), p["tstatic"])


def _forward_args(p, max_steps=100_000):
    """(field, weights, x0b, f0, dt0, ts, rtol, atol, safety, ifactor,
    dfactor, max_steps, controller) of the GP field."""
    A, x0, ts, st = _inputs(p)
    Z = st.Z.float()
    x0b, f0, dt0 = tg._pack_initial(A, x0, Z, st.sf, st.ell, 1e-7, 1e-9)
    return (gp_field(st.sf, st.ell), (A, Z), x0b, f0, dt0, ts, 1e-7, 1e-9,
            0.9, 10.0, 0.2, max_steps, "i")


def test_recording_forward_equals_whole_solve(problem):
    ys_rec, nfe, nacc, nrej, t1, rec = fa.fwd(*_forward_args(problem),
                                              record=True, store_steps=128)
    ys_whole, st = tg.gp_dopri5_solve_whole(*_inputs(problem))
    assert torch.equal(ys_rec, ys_whole)
    assert torch.equal(nacc, st["n_accepted"])
    assert torch.equal(nfe, st["nfe"])
    ys_traj = gp_dopri5_trajectory(*_inputs(problem))
    assert torch.equal(ys_traj, ys_whole)


def test_records_hold_each_chains_accepted_steps(problem):
    *_, nacc, _, t1, rec = fa.fwd(*_forward_args(problem), record=True,
                                  store_steps=128)
    ts = problem["t"]
    NS = 10
    for c in range(rec.shape[2]):
        n = int(nacc[c])
        t0 = to_np(rec[:n, NS, c])
        dt = to_np(rec[:n, NS + 1, c])
        assert t0[0] == ts[0] and np.all(dt > 0)
        # the mesh is contiguous: each accepted step starts where the last
        # one ended (the same float32 addition as the solver's)
        np.testing.assert_array_equal(t0[1:], (t0[:-1] + dt[:-1])
                                      .astype(np.float32))
        assert np.float32(t0[-1] + dt[-1]) == float(t1[c]) >= ts[-1]
        np.testing.assert_array_equal(to_np(rec[0, :NS, c]),
                                      problem["x0"].reshape(-1))
        assert not rec[n:, :, c].any()


def test_replay_backward_matches_jax_grad(problem):
    p = problem
    f32 = jnp.float32

    def loss(A, x0):
        ys = jax_trajectory(A, x0, jnp.asarray(p["t"]), p["jstatic32"],
                            store_steps=128, tile=128, interpret=True)
        return jnp.sum(ys * jnp.asarray(p["W"]))

    gA, gx0 = jax.grad(loss, argnums=(0, 1))(jnp.asarray(p["A"], f32),
                                              jnp.asarray(p["x0"], f32))
    A, x0, ts, st = _inputs(p)
    A.requires_grad_(True)
    x0.requires_grad_(True)
    ys = gp_dopri5_trajectory(A, x0, ts, st)
    (ys * torch.tensor(p["W"])).sum().backward()
    assert max_rel(A.grad, gA) <= 1e-3
    assert max_rel(x0.grad, gx0) <= 1e-3


def test_replay_backward_matches_autograd_of_plain_forward(problem):
    """The replay backward against autograd through the plain forward (step
    sizes detached there: the same frozen-mesh gradient, computed by
    autograd instead of the hand-written adjoint)."""
    W = torch.tensor(problem["W"])
    grads = []
    for fn in (gp_dopri5_trajectory, gp_dopri5_trajectory_plain):
        A, x0, ts, st = _inputs(problem)
        A.requires_grad_(True)
        x0.requires_grad_(True)
        (fn(A, x0, ts, st) * W).sum().backward()
        grads.append((A.grad, x0.grad))
    (gA, gx), (gA_ag, gx_ag) = grads
    assert max_rel(gA, gA_ag) <= 1e-3
    assert max_rel(gx, gx_ag) <= 1e-3


def test_record_overflow_raises(problem):
    with pytest.raises(RuntimeError, match="store_steps"):
        fa.fwd(*_forward_args(problem), record=True, store_steps=4)
    A, x0, ts, st = _inputs(problem)
    with pytest.raises(RuntimeError, match="store_steps"):
        gp_dopri5_trajectory(A, x0, ts, st, store_steps=4)


def test_backward_passes_unreached_times_no_cotangent(problem):
    """Cotangents on output times no step emitted (budget exhaustion: rows
    holding the final state) do not enter the adjoint, as in the JAX
    kernel."""
    args = _forward_args(problem, max_steps=5)
    ys, _, nacc, _, t1, rec = fa.fwd(*args, record=True, store_steps=8)
    field, w, ts = args[0], args[1], args[5]
    held = ts[:, None] > t1[None, :]                   # (T, C)
    assert held.any()
    g = held[..., None, None].float().expand_as(ys).contiguous()
    (Abar,), lbar = fa.bwd(field, w, ts, rec, nacc, g)
    assert not Abar.any() and not lbar.any()
