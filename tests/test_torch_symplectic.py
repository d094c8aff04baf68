"""Parity of the port's symplectic steppers (symplectic_euler, leapfrog /
verlet, yoshida4 on (q, p) states) with the JAX package's, in float64 on
the CPU: a batch of pendulums (one start angle a system) against the JAX
solve vmapped over them, the same grid steps to 1e-12; the long-horizon
energy error stays bounded; nfe, the step_size grid and the Kahan
carry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ode import odeint as jodeint
from bayesian_ode_tpu.ode import odeint_with_stats as jstats
from bayesian_ode_tpu_torch.ode import odeint, odeint_with_stats
from torch_parity import one_torch_thread, to_np  # noqa: F401

METHODS = ["symplectic_euler", "leapfrog", "verlet", "yoshida4"]
Q0 = np.array([0.3, 1.0, 1.5, 2.5])


def jpendulum(t, y):
    q, p = y
    return p, -jnp.sin(q)


def tpendulum(t, y):
    q, p = y
    return p, -torch.sin(q)


def _both(method, ts, options=None):
    def one(q0):
        return jstats(jpendulum, (q0[None], jnp.zeros(1)), jnp.asarray(ts),
                      method=method, options=options)

    (qj, pj), st_j = jax.vmap(one)(jnp.asarray(Q0))
    y0 = (torch.tensor(Q0)[:, None], torch.zeros(len(Q0), 1,
                                                 dtype=torch.float64))
    (q, p), st = odeint_with_stats(tpendulum, y0, torch.tensor(ts),
                                   method=method, options=options,
                                   batched=True)
    return (q.transpose(0, 1), p.transpose(0, 1), st), (qj, pj, st_j)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("options", [None, {"step_size": 0.07},
                                     {"compensated": True}])
def test_batched_steps_match_jax(method, options):
    (q, p, st), (qj, pj, st_j) = _both(method, np.linspace(0.0, 3.0, 31),
                                       options)
    np.testing.assert_allclose(to_np(q), np.asarray(qj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(to_np(p), np.asarray(pj), rtol=0, atol=1e-12)
    for k in ("nfe", "n_accepted"):
        np.testing.assert_array_equal(to_np(st[k]), np.asarray(st_j[k]))


@pytest.mark.parametrize("method,tol", [
    ("symplectic_euler", 0.11), ("verlet", 6e-3), ("yoshida4", 2e-5)])
def test_energy_bounded_long_horizon(method, tol):
    """5,000 pendulum steps at h = 0.1 (the JAX package's test; the card
    runs 10^4 in chip_smoke.py phase 31): the energy error stays at its
    per-step level."""
    ts = torch.linspace(0.0, 500.0, 5001, dtype=torch.float64)
    q0 = torch.tensor([1.5], dtype=torch.float64)
    qs, ps = odeint(tpendulum, (q0, torch.zeros_like(q0)), ts,
                    method=method)
    H = ps[:, 0] ** 2 / 2 - torch.cos(qs[:, 0])
    drift = (H - (0.0 - np.cos(1.5))).abs()
    assert float(drift.max()) < tol
    # bounded: the second half drifts no further than the first
    half = drift.shape[0] // 2
    assert float(drift[half:].max()) < 2 * float(drift[:half].max())


def test_step_size_option_nfe_and_yoshida_order():
    y0 = (torch.tensor([1.0], dtype=torch.float64),
          torch.tensor([0.0], dtype=torch.float64))
    osc = lambda t, y: (y[1], -y[0])  # noqa: E731
    _, st = odeint_with_stats(osc, y0, torch.linspace(0.0, 1.0, 3),
                              method="verlet", options={"step_size": 0.01})
    assert int(st["n_accepted"]) == 100 and int(st["nfe"]) == 300
    errs = []
    for n in (40, 80):
        qs, _ = odeint(osc, y0, torch.linspace(0.0, 2.0, n + 1,
                                               dtype=torch.float64),
                       method="yoshida4")
        errs.append(abs(float(qs[-1, 0]) - np.cos(2.0)))
    assert np.log2(errs[0] / errs[1]) > 3.65


def test_gradient_and_non_tuple_state():
    """Autograd through the steps: d q(1) / d q0 = cos(1) on the
    oscillator, as the JAX package's grad; a non-(q, p) state raises."""
    q0 = torch.ones(1, dtype=torch.float64, requires_grad=True)
    qs, _ = odeint(lambda t, y: (y[1], -y[0]), (q0, torch.zeros(1,
                   dtype=torch.float64)),
                   torch.linspace(0.0, 1.0, 51, dtype=torch.float64),
                   method="yoshida4")
    qs[-1].sum().backward()
    g_j = jax.grad(lambda q: jodeint(lambda t, y: (y[1], -y[0]),
                                     (q, jnp.zeros(1)),
                                     jnp.linspace(0.0, 1.0, 51),
                                     method="yoshida4")[0][-1].sum())(
        jnp.ones(1))
    np.testing.assert_allclose(to_np(q0.grad), np.asarray(g_j), rtol=1e-12)
    with pytest.raises(ValueError, match="2-tuple"):
        odeint(lambda t, y: -y, torch.ones(2, dtype=torch.float64),
               torch.linspace(0.0, 1.0, 3), method="verlet")
