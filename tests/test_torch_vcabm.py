"""Parity of the port's variable-order Adams method ("adams", VCABM) with
the JAX package's `integrate_vcabm`, in float64 on the CPU.

A batch of 4 Van der Pol systems in the port against the JAX solve
vmapped over them: the same steps on every system (80 to 130 accepted a
system), each system's order trajectory step by step, and trajectories
within 2e-9 max|y|.  That bar is not 1e-10: VCABM's divided differences
subtract nearly equal slopes, so the solve amplifies the rounding of the
field (XLA fuses its multiply-adds, torch does not) about 10^6 times; the
JAX solve itself moves by 1.5e-9 when y0 moves by 1e-15 relative, and on
[0, 6] that perturbation changes its accepted steps on system 0 from 180
to 188 (`test_jax_counts_move_under_an_ulp`), which bounds where step
counts can be held equal.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import odeint_adjoint as jadjoint
from bayesian_ode_tpu.ode import odeint_with_stats as jstats
from bayesian_ode_tpu_torch.ode import odeint, odeint_adjoint, \
    odeint_with_stats
from bayesian_ode_tpu_torch.utils.pytree import tree_leaves
from torch_parity import (VDP_MU, VDP_TS, VDP_Y0, check_solve64,  # noqa
                          jvdp, one_torch_thread, to_np, vdp_both)

jv = importlib.import_module("bayesian_ode_tpu.ode.vcabm")
tv = importlib.import_module("bayesian_ode_tpu_torch.ode.vcabm")


def check_within_jax_spread(options, rtol=1e-7):
    """The port within 10x (at least 1e-10 max|y|) of how far the JAX
    solve moves when y0 moves by 1e-15 relative, and the same steps on
    every system wherever that perturbation leaves JAX's steps alone.
    Returns the port's stats."""
    ys, st, ys_j, st_j = vdp_both("adams", options, rtol=rtol,
                                  atol=rtol * 1e-2)
    _, _, ys_p, st_p = vdp_both("adams", options, rtol=rtol,
                                atol=rtol * 1e-2, y0=VDP_Y0 * (1 + 1e-15))
    scale = np.abs(np.asarray(ys_j)).max()
    spread = np.abs(np.asarray(ys_p) - np.asarray(ys_j)).max() / scale
    err = np.abs(to_np(ys) - np.asarray(ys_j)).max() / scale
    assert err <= max(10 * spread, 1e-10), (err, spread)
    if all(np.array_equal(np.asarray(st_p[k]), np.asarray(st_j[k]))
           for k in ("nfe", "n_accepted", "n_rejected")):
        check_solve64(ys, st, ys_j, st_j, traj_tol=max(10 * spread, 1e-10))
    return st


@pytest.mark.parametrize("options,rtol", [
    (None, 1e-7), ({"mode": "bounded", "safety": 0.95}, 1e-5),
    ({"dfactor": 0.3}, 1e-7)])
def test_batched_solves_match_jax(options, rtol):
    """(the dfactor 0.3 case moves JAX's own steps under the perturbation:
    there the trajectories only are held)"""
    st = check_within_jax_spread(options, rtol)
    assert int(st["n_accepted"].min()) >= 30


@pytest.mark.parametrize("options", [
    {"mode": "bounded", "max_steps_per_interval": 6}, {"max_num_steps": 40}])
def test_bounded_cap_and_budget_match_jax(options):
    """The bounded mode's per-interval cap and the while mode's step
    budget stop systems short; the output is the state reached."""
    st = check_within_jax_spread(options)
    assert not to_np(st["reached_final_time"]).all()


def test_order_cap_follows_the_reference():
    """A system at max_order reads implicit phi[max_order]: the reference
    computes it, the JAX package's gather reads NaN past its history and
    the system stalls (every later step rejects with a NaN step size).
    At max_order 4 every system gets there within 5 steps: the JAX solve
    stalls on all four, the port's reaches the end, within 3e-4 of a
    tight dopri5 solve (the default max_order's solve is within 2e-4:
    the predictor quirk's global error)."""
    opts = {"max_order": 4, "max_num_steps": 2000}
    ys, st, ys_j, st_j = vdp_both("adams", opts)
    assert not np.asarray(st_j["reached_final_time"]).any()
    assert (np.asarray(st_j["n_accepted"]) < 15).all()
    assert to_np(st["reached_final_time"]).all()
    ref, _, _, _ = vdp_both("dopri5", rtol=1e-12, atol=1e-12)
    assert np.abs(to_np(ys) - to_np(ref)).max() < 1e-3


def _orders(monkeypatch, b):
    """Each call's (order, dt) of the step-size rule on system b, in both
    packages: the rejected-step rule at the order, then the accepted
    one's at order + 1, every attempted step."""
    rec_j, rec_t = [], []
    orig_j, orig_t = jv.optimal_step_size, tv.optimal_step_size

    def wj(dt, r, s, i, d, order):
        jax.debug.callback(lambda o, h: rec_j.append((int(o), float(h))),
                           order, dt)
        return orig_j(dt, r, s, i, d, order)

    def wt(dt, r, s, i, d, order):
        rec_t.append((int(order), float(dt)))
        return orig_t(dt, r, s, i, d, order)

    monkeypatch.setattr(jv, "optimal_step_size", wj)
    monkeypatch.setattr(tv, "optimal_step_size", wt)
    mu = VDP_MU[b]
    jstats(lambda t, y: jvdp(t, y, mu), jnp.asarray(VDP_Y0[b]),
           jnp.asarray(VDP_TS), method="adams")
    odeint_with_stats(lambda t, y: torch.stack(
        [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]]),
        torch.tensor(VDP_Y0[b]), torch.tensor(VDP_TS), method="adams")
    return rec_j, rec_t


@pytest.mark.parametrize("b", [0, 3])
def test_order_trajectory_matches_jax(monkeypatch, b):
    rec_j, rec_t = _orders(monkeypatch, b)
    assert len(rec_j) == len(rec_t) >= 60
    assert [o for o, _ in rec_t] == [o for o, _ in rec_j]
    assert max(o for o, _ in rec_t) >= 5             # past the startup cap
    # the step sizes drift apart by the rounding the solve amplifies (the
    # module docstring): 0.6% at most on these systems
    np.testing.assert_allclose([h for _, h in rec_t],
                               [h for _, h in rec_j], rtol=1e-2)


def test_one_system_equals_its_row_of_the_batch():
    yb, sb = odeint_with_stats(lambda t, y: torch.stack(
        [y[:, 1], torch.tensor(VDP_MU) * (1 - y[:, 0] ** 2) * y[:, 1]
         - y[:, 0]], 1), torch.tensor(VDP_Y0), torch.tensor(VDP_TS),
        method="adams", batched=True)
    for b in range(4):
        mu = VDP_MU[b]
        y, s = odeint_with_stats(lambda t, y: torch.stack(
            [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]]),
            torch.tensor(VDP_Y0[b]), torch.tensor(VDP_TS), method="adams")
        torch.testing.assert_close(y, yb[:, b], rtol=0, atol=0)
        assert int(s["nfe"]) == int(sb["nfe"][b])


@pytest.mark.parametrize("tree", [False, True])
def test_in_place_loop_equals_the_loop(monkeypatch, tree):
    """The "while" loop committed in place (the body the card captures as
    one CUDA graph, run here without the graph): bit for bit the steps
    and states of the loop that builds a new state a step, on one tensor
    and on a two-leaf tree (raveled)."""
    mu = torch.tensor(VDP_MU)[:, None]

    def field(t, y):
        if tree:
            p, v = y
            return v, mu * (1 - p ** 2) * v - p
        return torch.cat([y[:, 1:], mu * (1 - y[:, :1] ** 2) * y[:, 1:]
                          - y[:, :1]], 1)

    y0 = torch.tensor(VDP_Y0)
    y0 = (y0[:, :1], y0[:, 1:]) if tree else y0
    ts = torch.tensor(VDP_TS[:5])
    ys, st = odeint_with_stats(field, y0, ts, method="adams", batched=True)
    monkeypatch.setattr(tv, "graphable", lambda device: True)
    with torch.no_grad():
        ys_i, st_i = odeint_with_stats(field, y0, ts, method="adams",
                                       batched=True)
    for a, b in zip(tree_leaves(ys), tree_leaves(ys_i)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in ("nfe", "n_accepted", "n_rejected", "reached_final_time"):
        assert torch.equal(st[k], st_i[k]), k


def test_jax_counts_move_under_an_ulp():
    """The rounding sensitivity the trajectory bar allows for, in the JAX
    package alone: y0 (1 + 1e-15) changes system 0's accepted steps on
    [0, 6]."""
    ts = jnp.linspace(0.0, 6.0, 13)
    mu = VDP_MU[0]
    counts = [int(jstats(lambda t, y: jvdp(t, y, mu),
                         jnp.asarray(VDP_Y0[0] * (1 + eps)), ts,
                         method="adams")[1]["n_accepted"])
              for eps in (0.0, 1e-15)]
    assert counts[0] != counts[1]


def test_adjoint_gradient_matches_jax_and_dopri5():
    """The JAX package's test_adjoint_adams_vs_direct_dopri5: the adams
    adjoint gradient of sum(ys) for y' = (y^3) A^T within 5e-2 of
    autograd through a tight dopri5 loop (gradients of about 40), and
    the port's adams adjoint against the JAX adams adjoint to 1e-6.  At
    rtol 1e-8 / atol 1e-11 (the JAX test's 1e-9 / 1e-12 takes 15,000
    backward steps, 80-110 s here; at 1e-8 the adams gradient is 4.5e-2
    from the dopri5 one, at 1e-7 9.6e-2)."""
    A = np.array([[-0.1, 2.0], [-2.0, -0.1]])
    y0, t = np.array([2.0, 0.0]), np.linspace(0.0, 1.0, 10)

    def jadams(A_):
        return jnp.sum(jadjoint(lambda tt, y: (y ** 3) @ A_.T,
                                jnp.asarray(y0), jnp.asarray(t), rtol=1e-8,
                                atol=1e-11, method="adams"))

    g_j = np.asarray(jax.grad(jadams)(jnp.asarray(A)))
    At = torch.tensor(A, requires_grad=True)
    odeint_adjoint(lambda tt, y: (y ** 3) @ At.T, torch.tensor(y0),
                   torch.tensor(t), rtol=1e-8, atol=1e-11, method="adams",
                   adjoint_params=(At,)).sum().backward()
    Ad = torch.tensor(A, requires_grad=True)
    odeint(lambda tt, y: (y ** 3) @ Ad.T, torch.tensor(y0), torch.tensor(t),
           rtol=1e-9, atol=1e-11, method="dopri5",
           options={"mode": "bounded", "max_steps_per_interval": 64}
           ).sum().backward()
    assert float(Ad.grad.abs().max()) > 10
    assert float((At.grad - Ad.grad).abs().max()) < 5e-2
    np.testing.assert_allclose(to_np(At.grad), g_j, rtol=1e-6,
                               atol=1e-6 * np.abs(g_j).max())


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="vcabm mode"):
        odeint(lambda t, y: -y, torch.ones(2, dtype=torch.float64),
               torch.linspace(0, 1, 3), method="adams",
               options={"mode": "while_scan"})
