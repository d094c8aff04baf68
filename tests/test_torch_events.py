"""Parity of the port's `odeint_event` with the JAX package's, in float64
on the CPU: the event time and state of exponential decay y' = -a y at
y = c (t* = log(y0/c)/a), its three implicit-function gradients (y0, the
field's a, the event function's c), the moving-boundary cancellation in
the event state, a batch of systems each with its own event against the
JAX solve vmapped over them, reverse time, no event (NaN), an immediate
event, t_max, a stiff march, and the rejection of fixed-grid methods."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import odeint_adjoint as jadjoint
from bayesian_ode_tpu import odeint_event as jevent
from bayesian_ode_tpu import odeint_event_with_stats as jevent_stats
from bayesian_ode_tpu_torch import (odeint_adjoint, odeint_event,
                                    odeint_event_with_stats)
from torch_parity import one_torch_thread, to_np  # noqa: F401

A, C = 1.3, 0.7
T_TRUE = math.log(2.0 / C) / A


def jf(t, y):
    return -A * y


def tf(t, y):
    return -A * y


def _y(v):
    return torch.tensor([v], dtype=torch.float64)


@pytest.mark.parametrize("method,tol", [("dopri5", 1e-7), ("tsit5", 1e-7),
                                        ("bosh3", 1e-6)])
def test_event_time_state_and_stats_match_jax(method, tol):
    et_j, ys_j, st_j = jevent_stats(jf, jnp.array([2.0]), 0.0,
                                    event_fn=lambda t, y: y[0] - C,
                                    method=method)
    et, ys, st = odeint_event_with_stats(tf, _y(2.0), 0.0,
                                         event_fn=lambda t, y: y[0] - C,
                                         method=method)
    assert bool(st["event_found"])
    assert abs(float(et) - T_TRUE) < tol
    assert ys.shape == (2, 1) and float(ys[0, 0]) == 2.0
    np.testing.assert_allclose(float(et), float(et_j), rtol=1e-12)
    np.testing.assert_allclose(to_np(ys), np.asarray(ys_j), rtol=1e-10)
    for k in ("nfe", "n_accepted", "n_rejected"):
        assert int(st[k]) == int(st_j[k]), k


@pytest.mark.parametrize("how", ["bounded", "adjoint"])
def test_gradient_wrt_y0(how):
    """dt*/dy0 = 1/(a y0), through the bounded loop or the adjoint."""
    y0 = torch.tensor([2.0], dtype=torch.float64, requires_grad=True)
    kw = ({"options": {"mode": "bounded"}} if how == "bounded"
          else {"odeint_interface": odeint_adjoint})
    et, _ = odeint_event(tf, y0, 0.0, event_fn=lambda t, y: y[0] - C, **kw)
    et.backward()
    jkw = ({"options": {"mode": "bounded"}} if how == "bounded"
           else {"odeint_interface": jadjoint})
    g_j = jax.grad(lambda v: jevent(jf, jnp.array([v]), 0.0,
                                    event_fn=lambda t, y: y[0] - C,
                                    **jkw)[0])(2.0)
    assert abs(float(y0.grad) - 1.0 / (A * 2.0)) < 1e-6
    np.testing.assert_allclose(float(y0.grad), float(g_j), rtol=1e-8)


def test_gradients_wrt_field_and_event_params():
    """dt*/da = -t*/a through the field, dt*/dc = -1/(a c) through the
    event function."""
    a = torch.tensor(A, dtype=torch.float64, requires_grad=True)
    c = torch.tensor(C, dtype=torch.float64, requires_grad=True)
    et, _ = odeint_event(lambda t, y: -a * y, _y(2.0), 0.0,
                         event_fn=lambda t, y: y[0] - c,
                         options={"mode": "bounded"})
    et.backward()
    assert abs(float(a.grad) + T_TRUE / A) < 1e-6
    assert abs(float(c.grad) + 1.0 / (A * C)) < 1e-6
    ga = jax.grad(lambda a_: jevent(lambda t, y: -a_ * y, jnp.array([2.0]),
                                    0.0, event_fn=lambda t, y: y[0] - C,
                                    options={"mode": "bounded"})[0])(A)
    np.testing.assert_allclose(float(a.grad), float(ga), rtol=1e-8)


def test_moving_boundary_cancels_in_event_state():
    """y(t*) == c identically in y0: the total derivative is ~0 (exp(-a
    t*) ~ 0.35 without the f dt* term)."""
    y0 = torch.tensor([2.0], dtype=torch.float64, requires_grad=True)
    _, ys = odeint_event(tf, y0, 0.0, event_fn=lambda t, y: y[0] - C,
                         options={"mode": "bounded"})
    ys[-1, 0].backward()
    assert abs(float(y0.grad)) < 1e-6


def test_batched_events_match_jax_vmap():
    """Each system of the batch marches to its own event, bisects on its
    own crossing step, and re-solves to its own time."""
    y0s = np.array([1.5, 2.0, 3.0, 0.6])       # the last: no event
    f_j = jax.vmap(lambda y: jevent_stats(jf, y[None], 0.0,
                                          event_fn=lambda t, s: s[0] - C,
                                          t_max=3.0))
    et_j, ys_j, st_j = f_j(jnp.asarray(y0s))
    et, ys, st = odeint_event_with_stats(
        tf, torch.tensor(y0s)[:, None], 0.0,
        event_fn=lambda t, y: y[:, 0] - C, t_max=3.0, batched=True)
    assert et.shape == (4,) and ys.shape == (2, 4, 1)
    np.testing.assert_allclose(to_np(et), np.asarray(et_j), rtol=1e-12)
    assert np.isnan(to_np(et)[-1])
    np.testing.assert_allclose(to_np(ys).transpose(1, 0, 2),
                               np.asarray(ys_j), rtol=1e-10)
    for k in ("nfe", "n_accepted", "n_rejected", "event_found"):
        np.testing.assert_array_equal(to_np(st[k]), np.asarray(st_j[k]))
    truth = np.log(y0s[:3] / C) / A
    assert np.abs(to_np(et)[:3] - truth).max() < 1e-7


def test_batched_gradient_per_system():
    y0 = torch.tensor([[1.5], [2.0], [3.0]], dtype=torch.float64,
                      requires_grad=True)
    et, _ = odeint_event(tf, y0, 0.0, event_fn=lambda t, y: y[:, 0] - C,
                         options={"mode": "bounded"}, batched=True)
    et.sum().backward()
    np.testing.assert_allclose(to_np(y0.grad)[:, 0],
                               1.0 / (A * np.array([1.5, 2.0, 3.0])),
                               atol=1e-6)


def test_projectile_reverse_time_immediate_and_no_event():
    et, ys = odeint_event(
        lambda t, s: torch.stack([s[1], torch.full_like(s[1], -9.8)]),
        torch.tensor([0.0, 5.0], dtype=torch.float64), 0.0,
        event_fn=lambda t, s: torch.where(t == 0.0, torch.ones_like(s[0]),
                                          s[0]))
    assert abs(float(et) - 2 * 5.0 / 9.8) < 1e-7
    assert abs(float(ys[-1, 1]) + 5.0) < 1e-6
    et, ys = odeint_event(tf, _y(2.0), 1.0, event_fn=lambda t, y: y[0] - 3.0,
                          reverse_time=True)
    et_j, _ = jevent(jf, jnp.array([2.0]), 1.0,
                     event_fn=lambda t, y: y[0] - 3.0, reverse_time=True)
    assert abs(float(et) - (1.0 - math.log(1.5) / A)) < 1e-7
    np.testing.assert_allclose(float(et), float(et_j), rtol=1e-12)
    assert abs(float(ys[-1, 0]) - 3.0) < 1e-7
    et, ys = odeint_event(tf, _y(2.0), 0.0, event_fn=lambda t, y: y[0] - 2.0)
    assert abs(float(et)) < 1e-12 and abs(float(ys[-1, 0]) - 2.0) < 1e-9
    et, ys, st = odeint_event_with_stats(
        tf, _y(2.0), 0.0, event_fn=lambda t, y: y[0] + 5.0, t_max=1.0)
    assert not bool(st["event_found"]) and bool(torch.isnan(et))
    assert bool(torch.isfinite(ys).all())


def test_stiff_sdirk4_event_and_errors():
    lam = 1e6
    et, ys, st = odeint_event_with_stats(
        lambda t, y: -lam * (y - torch.cos(t)), _y(1.0), 0.0,
        event_fn=lambda t, y: y[0] - 0.5, method="sdirk4", rtol=1e-6,
        atol=1e-8)
    assert bool(st["event_found"])
    t = float(et)
    assert abs(math.cos(t) + math.sin(t) / lam - 0.5) < 1e-6
    assert int(st["n_accepted"]) + int(st["n_rejected"]) < 2000
    for method in ("rk4", "adams"):
        with pytest.raises(ValueError, match="adaptive method"):
            odeint_event(tf, _y(2.0), 0.0, event_fn=lambda t, y: y[0] - C,
                         method=method)
    with pytest.raises(ValueError, match="scalar"):
        odeint_event(tf, _y(2.0), 0.0, event_fn=lambda t, y: y - C)
