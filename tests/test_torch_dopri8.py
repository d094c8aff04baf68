"""Parity of the port's dopri8 (DOP853: the composite 8(5,3) error, the
7th-order dense output with its 3 RHS evaluations a step) with the JAX
package's, in float64 on the CPU: the same steps on every system of a
batch and trajectories within 1e-10 max|y|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ode import odeint as jodeint
from bayesian_ode_tpu_torch.ode import odeint, odeint_with_stats
from bayesian_ode_tpu_torch.ode.tableaus import DOPRI8
from torch_parity import (VDP_TS, check_solve64, one_torch_thread,  # noqa: F401
                          to_np, vdp_both)


def test_tableau_consistency():
    assert DOPRI8.is_fsal and DOPRI8.nfe_per_step == 12 and DOPRI8.order == 8
    for a, row in zip(DOPRI8.alpha, DOPRI8.beta):
        assert abs(sum(row) - a) < 1e-12
    assert abs(sum(DOPRI8.c_sol) - 1.0) < 1e-12
    assert abs(sum(DOPRI8.c_error)) < 1e-12


@pytest.mark.parametrize("options", [None, {"interp": "quartic"},
                                     {"controller": "pi"},
                                     {"mode": "bounded"}])
def test_batched_solves_match_jax(options):
    ys, st, ys_j, st_j = vdp_both("dopri8", options, rtol=1e-9, atol=1e-11)
    check_solve64(ys, st, ys_j, st_j)
    # 12 stages an attempt, plus 3 for the dense output unless quartic
    extra = 0 if options and options.get("interp") == "quartic" else 3
    np.testing.assert_array_equal(
        to_np(st["nfe"]),
        2 + (12 + extra) * to_np(st["n_accepted"] + st["n_rejected"]))


def test_dense_output_between_steps_matches_jax():
    """Output times far inside the steps: the DOP853 polynomial itself."""
    ts = np.linspace(0.0, 6.0, 61)
    y0 = np.array([2.0, 0.0])
    f = lambda t, y: jnp.stack([y[1], (1 - y[0] ** 2) * y[1] - y[0]])  # noqa
    want = jodeint(f, jnp.asarray(y0), jnp.asarray(ts), rtol=1e-6,
                   atol=1e-9, method="dopri8")
    got, st = odeint_with_stats(
        lambda t, y: torch.stack([y[1], (1 - y[0] ** 2) * y[1] - y[0]]),
        torch.tensor(y0), torch.tensor(ts), rtol=1e-6, atol=1e-9,
        method="dopri8")
    assert int(st["n_accepted"]) < 60       # several outputs a step
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_bounded_mode_gradient_matches_jax():
    W = np.random.RandomState(3).randn(len(VDP_TS), 2)

    def jloss(mu):
        ys = jodeint(lambda t, y: jnp.stack(
            [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]]),
            jnp.asarray([1.0, 0.2]), jnp.asarray(VDP_TS), rtol=1e-8,
            atol=1e-10, method="dopri8", options={"mode": "bounded"})
        return jnp.sum(ys * W)

    g_j = jax.grad(jloss)(jnp.asarray(0.8))
    mu = torch.tensor(0.8, dtype=torch.float64, requires_grad=True)
    ys = odeint(lambda t, y: torch.stack(
        [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]]),
        torch.tensor([1.0, 0.2], dtype=torch.float64), torch.tensor(VDP_TS),
        rtol=1e-8, atol=1e-10, method="dopri8", options={"mode": "bounded"})
    (ys * torch.tensor(W)).sum().backward()
    np.testing.assert_allclose(float(mu.grad), float(g_j), rtol=1e-8)
