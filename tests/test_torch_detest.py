"""The DETEST gate for the port's solvers (Hull, Enright, Fellen &
Sedgwick 1972, "Comparing numerical methods for ordinary differential
equations"): the subset A1, A3, B1, B4, C3, D2, E2 at rtol = atol = 1e-6
over [0, 20] against a 1e-12 solve (RMS < 5e-3, NFE < 2,500) with the
JAX package's NFE on every problem; adams on A1, B1 and D1 within 0.1;
the analytic A1 to A4 within 1e-8.  The problems are written once over an
array module, so the same definitions feed torch and jax.numpy."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ode import odeint_with_stats as jstats
from bayesian_ode_tpu_torch.ode import odeint_with_stats
from torch_parity import one_torch_thread, to_np  # noqa: F401


def _tridiag(n):
    A = np.zeros((n, n))
    np.fill_diagonal(A, -2.0)
    A[np.arange(1, n), np.arange(n - 1)] = 1.0
    A[np.arange(n - 1), np.arange(1, n)] = 1.0
    return A


def problems(xp):
    """{name: (field, y0, exact solution or None)} over the array module
    xp (torch or jax.numpy), float64."""
    def arr(x):
        return xp.asarray(np.asarray(x, dtype=np.float64))

    def orbit(eps):
        def f(t, y):
            r = (y[0] ** 2 + y[1] ** 2) ** 1.5
            return xp.stack([y[2], y[3], -y[0] / r, -y[1] / r])

        return f, arr([1 - eps, 0.0, 0.0, math.sqrt((1 + eps) / (1 - eps))])

    A3 = arr(_tridiag(10))
    c3_y0 = np.zeros(10)
    c3_y0[0] = 1.0
    out = {
        "A1": (lambda t, y: -y, arr(1.0), lambda t: xp.exp(-t)),
        "A2": (lambda t, y: -(y ** 3) / 2, arr(1.0),
               lambda t: 1 / xp.sqrt(t + 1)),
        "A3": (lambda t, y: y * xp.cos(t), arr(1.0),
               lambda t: xp.exp(xp.sin(t))),
        "A4": (lambda t, y: y / 4 * (1 - y / 20), arr(1.0),
               lambda t: 20 / (1 + 19 * xp.exp(-t / 4))),
        "B1": (lambda t, y: xp.stack([2 * (y[0] - y[0] * y[1]),
                                      -(y[1] - y[0] * y[1])]),
               arr([1.0, 3.0]), None),
        "B4": (lambda t, y: xp.stack([
            -y[1] - y[0] * y[2] / xp.sqrt(y[0] ** 2 + y[1] ** 2),
            y[0] - y[1] * y[2] / xp.sqrt(y[0] ** 2 + y[1] ** 2),
            y[0] / xp.sqrt(y[0] ** 2 + y[1] ** 2)]),
               arr([3.0, 0.0, 0.0]), None),
        "C3": (lambda t, y: A3 @ y, arr(c3_y0), None),
        "D1": orbit(0.1) + (None,),
        "D2": orbit(0.3) + (None,),
        "E2": (lambda t, y: xp.stack([y[1], (1 - y[0] ** 2) * y[1] - y[0]]),
               arr([2.0, 0.0]), None),
    }
    return out


SUBSET = ["A1", "A3", "B1", "B4", "C3", "D2", "E2"]
TP, JP = problems(torch), problems(jnp)
TS = np.array([0.0, 20.0])


def solve(name, rtol, atol, method):
    f, y0, _ = TP[name]
    ys, st = odeint_with_stats(f, y0, torch.tensor(TS), rtol, atol, method)
    return ys[-1], st


@pytest.mark.parametrize("name", SUBSET)
def test_dopri5_vs_tight_reference(name):
    ref, _ = solve(name, 1e-12, 1e-12, "dopri5")
    est, st = solve(name, 1e-6, 1e-6, "dopri5")
    err = float(torch.sqrt(torch.mean((ref - est) ** 2)))
    assert err < 5e-3, (name, err)
    assert bool(st["reached_final_time"])
    assert int(st["nfe"]) < 2500
    f, y0, _ = JP[name]
    _, st_j = jstats(f, y0, jnp.asarray(TS), 1e-6, 1e-6, "dopri5")
    for k in ("nfe", "n_accepted", "n_rejected"):
        assert int(st[k]) == int(st_j[k]), (name, k)


@pytest.mark.parametrize("name", ["A1", "B1", "D1"])
def test_adams_vs_tight_reference(name):
    ref, _ = solve(name, 1e-12, 1e-12, "dopri5")
    est, _ = solve(name, 1e-6, 1e-6, "adams")
    err = float(torch.sqrt(torch.mean((ref - est) ** 2)))
    assert err < 0.1, (name, err)


def test_analytic_solutions_where_known():
    for name in ["A1", "A2", "A3", "A4"]:
        f, y0, exact = TP[name]
        ys, _ = odeint_with_stats(f, y0, torch.tensor(TS), 1e-10, 1e-12,
                                  "dopri5")
        want = exact(torch.tensor(20.0, dtype=torch.float64))
        assert float((ys[-1] - want).abs().max()) < 1e-8, name
        np.testing.assert_allclose(to_np(want), float(JP[name][2](20.0)),
                                   rtol=1e-14)
