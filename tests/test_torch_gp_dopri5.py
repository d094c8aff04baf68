"""Parity of the port's whole-solve GP dopri5 (plain version of kernel K1)
with the JAX package's Pallas kernel run in interpret mode.

Tolerances.  The single-sourced step arithmetic is compared in float64 to
1e-12.  The float32 whole solves are compared at 1e-4 * max|y|: at
rtol=1e-7 the 32-ulps tolerance floor binds, so the error estimates are
float32 rounding noise in both implementations, and ulp-level differences
in exp and summation order (XLA reduces over the inducing points in its
own order) move the step mesh of some chains.  Two correct float32 solves
then differ by their own global error: measured 1.0e-5 to 4.5e-5 * max|y|
at this shape, over 8 and 128 chains and both controllers.  That is also
the gate the kernel is held to against this plain version on the card.
Mean NFE agrees within 1% and the mean accepted and rejected counts within
1% of the mean step count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ops import gp_dopri5 as jg
from bayesian_ode_tpu_torch.ops import gp_dopri5 as tg
from torch_parity import gp_problem, to_np


@pytest.fixture(scope="module")
def problem():
    return gp_problem()


@pytest.fixture(scope="module")
def problem128():
    # the JAX kernel pads the chain axis to 128 lanes in any case; 128
    # chains make the 1% gates on mean step counts statistically meaningful
    return gp_problem(C=128)


def _solve_both(p, controller, **kw):
    f32 = jnp.float32
    ys_j, st_j = jg.gp_dopri5_solve_whole(
        jnp.asarray(p["A"]), jnp.asarray(p["x0"]), jnp.asarray(p["t"]),
        p["jstatic32"], controller=controller, tile=128, interpret=True,
        **kw)
    ys_t, st_t = tg.gp_dopri5_solve_whole(
        torch.tensor(p["A"]), torch.tensor(p["x0"]), torch.tensor(p["t"]),
        p["tstatic"], controller=controller, **kw)
    assert ys_t.dtype == torch.float32 and ys_t.shape == ys_j.shape
    assert np.asarray(ys_j).dtype == f32
    return np.asarray(ys_j), st_j, to_np(ys_t), st_t


# The PI controller runs at rtol=1e-5: in the floor-bound regime of
# rtol=1e-7 its step counts follow the rounding statistics of the error
# estimates, which are float32 noise there (an estimate of exactly 0 leaves
# 0 in the controller's memory and shrinks the next step by dfactor).  Mean
# NFE measured 132.1 in the JAX kernel and 134.4 here over these 128
# chains, while at rtol=1e-5 every step's decision is truncation-driven.
@pytest.mark.parametrize("controller,rtol,atol", [("i", 1e-7, 1e-9),
                                                  ("pi", 1e-5, 1e-7)])
def test_whole_solve_matches_jax_kernel(problem128, controller, rtol, atol):
    problem = problem128
    ys_j, st_j, ys_t, st_t = _solve_both(problem, controller, rtol=rtol,
                                         atol=atol)
    scale = np.max(np.abs(ys_j))
    assert np.max(np.abs(ys_t - ys_j)) <= 1e-4 * scale
    np.testing.assert_array_equal(ys_t[0], np.broadcast_to(
        problem["x0"], ys_t[0].shape))
    nfe_j = float(np.mean(np.asarray(st_j["nfe"])))
    nfe_t = float(st_t["nfe"].float().mean())
    assert abs(nfe_t - nfe_j) <= 0.01 * nfe_j
    steps = float(np.mean(np.asarray(st_j["n_accepted"])
                          + np.asarray(st_j["n_rejected"])))
    for key in ("n_accepted", "n_rejected"):
        mj = float(np.mean(np.asarray(st_j[key])))
        mt = float(st_t[key].float().mean())
        assert abs(mt - mj) <= 0.01 * steps, (key, mt, mj)
    assert st_t["reached_final_time"] and bool(st_j["reached_final_time"])
    assert (st_t["nfe"] == 2 + 6 * (st_t["n_accepted"]
                                    + st_t["n_rejected"])).all()


def test_budget_exhaustion_holds_final_state(problem):
    """max_steps=5: output times never reached hold each chain's final
    state, in the port as in the JAX kernel."""
    ys_j, st_j, ys_t, st_t = _solve_both(problem, "i", max_steps=5)
    assert not st_t["reached_final_time"]
    assert not bool(st_j["reached_final_time"])
    assert (st_t["n_accepted"] + st_t["n_rejected"] == 5).all()
    for ys in (ys_j, ys_t):
        final = ys[-1]
        held = np.all(ys == final[None], axis=(2, 3))        # (T, C)
        # each chain: a non-empty tail of held rows, rows 1.. before it
        # emitted from the dense output
        assert held[-1].all()
        first = held.argmax(axis=0)
        assert np.all(first >= 1)
        for c in range(ys.shape[1]):
            assert held[first[c]:, c].all()
    # both stopped before the same output times (t=0.23 spacing)
    held_j = np.all(ys_j == ys_j[-1][None], axis=(2, 3)).sum(0)
    held_t = np.all(ys_t == ys_t[-1][None], axis=(2, 3)).sum(0)
    np.testing.assert_array_equal(held_t, held_j)


def _planes(y, RP=8):
    """(C, N, 2) -> the JAX kernels' (RP, C) x and y planes."""
    C, N = y.shape[:2]
    pad = np.zeros((RP - N, C))
    return (jnp.asarray(np.concatenate([y[:, :, 0].T, pad])),
            jnp.asarray(np.concatenate([y[:, :, 1].T, pad])))


def _unplanes(px, py, N):
    return np.stack([np.asarray(px)[:N].T, np.asarray(py)[:N].T], -1)


@pytest.mark.parametrize("controller", ["i", "pi"])
def test_step_arithmetic_matches_jax_f64(problem, controller):
    """One step of the single-sourced arithmetic (_make_rhs, _rk_stages,
    _step_decision, _midpoint, _quartic_coeffs) in float64, against the
    JAX helpers the Pallas kernels inline."""
    rng = np.random.RandomState(4)
    C, N = 8, 5
    A = problem["A"].astype(np.float64)
    Z = np.asarray(problem["jstatic64"].Z)
    y0 = rng.randn(C, N, 2)
    # step sizes spanning accept, reject and the r == 0 growth branch.  The
    # embedded error estimate cancels 7-9 digits of the stage derivatives,
    # so float64 rounding (exp and sums differ in the last bit between the
    # frameworks) leaves ~1e-8 relative noise in the error ratio at these
    # steps: ratio and controller outputs are compared at 1e-7 / 1e-8,
    # everything else at 1e-12
    dt = np.array([0.1, 0.15, 0.2, 0.25, 0.3, 0.5, 1.0, 0.0])
    err_prev = rng.uniform(0.1, 2.0, C)
    rtol, atol = 1e-7, 1e-9

    rhs_j = jg._make_rhs(1.0, 0.75, N, 8, jnp.asarray(A[:, :, 0].T),
                         jnp.asarray(A[:, :, 1].T),
                         jnp.asarray(Z[:, 0:1]), jnp.asarray(Z[:, 1:2]))
    px, py = _planes(y0)
    fx, fy = rhs_j(px, py)
    dtj = jnp.asarray(dt[None])
    kx, ky, y1x, y1y, f1x, f1y = jg._rk_stages(rhs_j, px, py, fx, fy, dtj)
    pi = controller == "pi"
    acc_j, ratio_j, dtn_j, ep_j = jg._step_decision(
        kx, ky, px, py, y1x, y1y, dtj, rtol, atol, 0.9, 10.0, 0.2, N, 8,
        err_prev=jnp.asarray(err_prev[None]) if pi else None)
    cx = jg._quartic_coeffs(px, y1x, jg._midpoint(px, kx, dtj), fx, f1x, dtj)
    cy = jg._quartic_coeffs(py, y1y, jg._midpoint(py, ky, dtj), fy, f1y, dtj)

    rhs_t = tg._make_rhs(torch.tensor(A), torch.tensor(Z), 1.0, 0.75)
    ty0 = torch.tensor(y0)
    tdt = torch.tensor(dt)
    f0 = rhs_t(ty0)
    k, y1 = tg._rk_stages(rhs_t, ty0, f0, tdt)
    acc_t, ratio_t, dtn_t, ep_t = tg._step_decision(
        k, ty0, y1, tdt, rtol, atol, 0.9, 10.0, 0.2,
        err_prev=torch.tensor(err_prev) if pi else None)
    ct = tg._quartic_coeffs(ty0, y1, tg._midpoint(ty0, k, tdt), f0, k[6],
                            tdt[:, None, None])

    def close(a, b, tol=1e-12):
        a, b = to_np(a), np.asarray(b)
        assert np.max(np.abs(a - b)) <= tol * max(np.max(np.abs(b)), 1e-300)

    close(f0, _unplanes(fx, fy, N))
    for j in range(7):
        close(k[j], _unplanes(kx[j], ky[j], N))
    close(y1, _unplanes(y1x, y1y, N))
    np.testing.assert_allclose(to_np(ratio_t), np.asarray(ratio_j)[0],
                               rtol=1e-7, atol=0)
    np.testing.assert_array_equal(to_np(acc_t), np.asarray(acc_j)[0])
    assert acc_t.any() and not acc_t.all()
    np.testing.assert_allclose(to_np(dtn_t), np.asarray(dtn_j)[0],
                               rtol=1e-8, atol=0)
    if pi:
        # (ratio == 0 puts sqrt(1e-38) in the memory, which XLA's CPU
        # backend flushes to 0 as a subnormal float32 constant)
        live = dt > 0
        np.testing.assert_allclose(to_np(ep_t)[live],
                                   np.asarray(ep_j)[0][live],
                                   rtol=1e-7, atol=0)
    else:
        assert ep_t is None and ep_j is None
    for a, bx, by in zip(ct, cx, cy):
        close(a, _unplanes(bx, by, N))


def test_unknown_controller_raises(problem):
    with pytest.raises(ValueError, match="controller"):
        tg.gp_dopri5_solve_whole(torch.tensor(problem["A"]),
                                 torch.tensor(problem["x0"]),
                                 torch.tensor(problem["t"]),
                                 problem["tstatic"], controller="pid")


def test_plain_version_is_the_cpu_path(problem):
    """The public wrapper and its plain version agree exactly on the CPU
    (the wrapper takes the plain path for CPU tensors)."""
    args = (torch.tensor(problem["A"]), torch.tensor(problem["x0"]),
            torch.tensor(problem["t"]), problem["tstatic"])
    ys_a, st_a = tg.gp_dopri5_solve_whole(*args)
    ys_b, st_b = tg.gp_dopri5_solve_whole_plain(*args)
    assert torch.equal(ys_a, ys_b)
    assert torch.equal(st_a["nfe"], st_b["nfe"])


def test_hairer_initial_step_matches_jax(problem):
    A = problem["A"]
    x0 = problem["x0"]
    C = A.shape[0]
    out = jg._pack_initial(jnp.asarray(A), jnp.asarray(x0),
                           problem["jstatic32"], 1e-7, 1e-9, C, 5, 8, 40)
    x0b, f0, dt0 = tg._pack_initial(
        torch.tensor(A), torch.tensor(x0), problem["tstatic"].Z.float(),
        1.0, 0.75, 1e-7, 1e-9)
    f0_j = _unplanes(out[2], out[3], 5)
    assert np.max(np.abs(to_np(f0) - f0_j)) <= 1e-5 * np.max(np.abs(f0_j))
    np.testing.assert_allclose(to_np(dt0), np.asarray(out[4])[0], rtol=1e-5)
    assert dt0.dtype == torch.float32
