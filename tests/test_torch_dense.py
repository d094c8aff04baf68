"""Parity of the port's `odeint_dense` / `DenseSolution` with the JAX
package's, in float64 on the CPU, case by case as the JAX package's
tests/test_dense.py: the dense solution against `odeint` on a grid and
against the JAX dense solution at the same query times, accuracy against
the closed form, query shapes, reverse spans, tree states, a batch of
systems each on its own mesh (JAX: vmap), capacity overflow, complex
states, a zero-length span, gradients, and the option check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import odeint_dense as jdense
from bayesian_ode_tpu_torch import DenseSolution, odeint, odeint_dense
from torch_parity import one_torch_thread, to_np  # noqa: F401


def f(t, y):
    return -y


def _t(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "dopri8", "bosh3",
                                    "sdirk4"])
def test_dense_matches_odeint_grid_and_jax(method):
    y0 = _t([1.0, 2.0])
    sol, stats = odeint_dense(f, y0, 0.0, 5.0, rtol=1e-7, atol=1e-9,
                              method=method)
    assert bool(stats["reached_final_time"])
    ts = torch.linspace(0.0, 5.0, 37, dtype=torch.float64)
    ys_grid = odeint(f, y0, ts, rtol=1e-7, atol=1e-9, method=method)
    assert float((sol(ts) - ys_grid).abs().max()) < 1e-6
    sol_j, st_j = jdense(lambda t, y: -y, jnp.array([1.0, 2.0]), 0.0, 5.0,
                         rtol=1e-7, atol=1e-9, method=method)
    np.testing.assert_allclose(to_np(sol(ts)), np.asarray(sol_j(
        jnp.asarray(to_np(ts)))), rtol=0, atol=1e-12)
    for k in ("nfe", "n_accepted", "n_rejected"):
        assert int(stats[k]) == int(st_j[k]), k


def test_dense_accuracy_scalar_and_shape_queries():
    sol, _ = odeint_dense(f, _t([1.0]), 0.0, 3.0, rtol=1e-8, atol=1e-10)
    ts = torch.linspace(0.0, 3.0, 101, dtype=torch.float64)
    assert float((sol(ts)[:, 0] - torch.exp(-ts)).abs().max()) < 1e-6
    sol, _ = odeint_dense(f, torch.ones(3, dtype=torch.float64), 0.0, 2.0)
    assert sol(1.3).shape == (3,)
    y2 = sol(torch.ones(4, 5, dtype=torch.float64) * 0.7)
    assert y2.shape == (4, 5, 3)
    torch.testing.assert_close(y2[0, 0], sol(0.7))
    assert isinstance(sol, DenseSolution) and sol.evaluate(0.7).shape == (3,)


def test_dense_reverse_time():
    sol, stats = odeint_dense(f, _t([1.0]), 2.0, 0.0, rtol=1e-8, atol=1e-10)
    assert bool(stats["reached_final_time"])
    sol_j, _ = jdense(lambda t, y: -y, jnp.array([1.0]), 2.0, 0.0,
                      rtol=1e-8, atol=1e-10)
    for t in (2.0, 1.0, 0.37, 0.0):
        assert abs(float(sol(t)[0]) - np.exp(-(t - 2.0))) < 1e-6
        np.testing.assert_allclose(float(sol(t)[0]), float(sol_j(t)[0]),
                                   rtol=1e-9)
    # the last step ends past the span, in both; the step sizes of y' = -y
    # follow error estimates that cancel to 1e-6 of the stages, so the two
    # packages' rounding moves the mesh by 1e-11 a step
    assert float(sol.t0) == 2.0 and float(sol.t1) <= 0.0
    np.testing.assert_allclose(float(sol.t1), float(sol_j.t1), rtol=0,
                               atol=1e-9)


def test_dense_tree_state():
    def g(t, y):
        return {"a": -y["a"], "b": 0.5 * y["b"]}

    sol, _ = odeint_dense(g, {"a": _t([1.0]), "b": _t([1.0])}, 0.0, 1.0,
                          rtol=1e-8, atol=1e-10)
    y = sol(0.5)
    assert abs(float(y["a"][0]) - np.exp(-0.5)) < 1e-7
    assert abs(float(y["b"][0]) - np.exp(0.25)) < 1e-7
    y2 = sol(_t([0.25, 0.75]))
    assert abs(float(y2["a"][1, 0]) - np.exp(-0.75)) < 1e-7


def test_dense_batch_per_system_meshes():
    """Per-system stiffness: each system on its own step mesh, as the JAX
    package's vmap of the dense solve."""
    lams = np.array([0.5, 2.0, 8.0])
    tq = np.linspace(0.0, 2.0, 9)

    def jsolve(lam):
        sol, st = jdense(lambda t, y: -lam * y, jnp.array([1.0]), 0.0, 2.0,
                         rtol=1e-8, atol=1e-10)
        return sol(jnp.asarray(tq)), st["n_accepted"]

    ys_j, n_j = jax.vmap(jsolve)(jnp.asarray(lams))
    lam = torch.tensor(lams)[:, None]
    sol, st = odeint_dense(lambda t, y: -lam * y,
                           torch.ones(3, 1, dtype=torch.float64), 0.0, 2.0,
                           rtol=1e-8, atol=1e-10, batched=True)
    ys = sol(torch.tensor(tq))
    assert ys.shape == (9, 3, 1)
    np.testing.assert_array_equal(to_np(st["n_accepted"]), np.asarray(n_j))
    assert len(set(to_np(st["n_accepted"]).tolist())) == 3
    np.testing.assert_allclose(to_np(ys).transpose(1, 0, 2), np.asarray(ys_j),
                               rtol=0, atol=1e-12)
    expect = np.exp(-lams[None, :] * tq[:, None])
    assert np.abs(to_np(ys)[..., 0] - expect).max() < 1e-6


def test_dense_capacity_overflow_is_reported():
    sol, stats = odeint_dense(f, _t([1.0]), 0.0, 50.0, rtol=1e-10,
                              atol=1e-12, options={"dense_steps": 4})
    assert not bool(stats["reached_final_time"])
    assert bool(torch.isfinite(sol(50.0)).all())
    assert float(sol.t1) < 50.0
    sol_j, _ = jdense(lambda t, y: -y, jnp.array([1.0]), 0.0, 50.0,
                      rtol=1e-10, atol=1e-12, options={"dense_steps": 4})
    # (the mesh of y' = -y to rounding, as in test_dense_reverse_time)
    np.testing.assert_allclose(float(sol.t1), float(sol_j.t1), rtol=1e-9)
    np.testing.assert_allclose(float(sol(0.1)[0]), float(sol_j(0.1)[0]),
                               rtol=1e-9)


def test_dense_complex_and_zero_length_span():
    w = 3.0
    sol, _ = odeint_dense(lambda t, y: 1j * w * y,
                          torch.tensor([1.0 + 0.0j], dtype=torch.complex128),
                          0.0, 2.0, rtol=1e-8, atol=1e-10)
    y = sol(1.37)
    assert torch.is_complex(y)
    assert abs(complex(y[0]) - np.exp(1j * w * 1.37)) < 1e-6
    y0 = _t([1.5, -2.0])
    sol, stats = odeint_dense(f, y0, 1.0, 1.0)
    assert bool(stats["reached_final_time"])
    torch.testing.assert_close(sol(1.0), y0)


def test_dense_gradients():
    """Autograd through the recorded solve (the JAX package's jacfwd) and
    with respect to the query time."""
    lam = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    sol, _ = odeint_dense(lambda t, y: -lam * y, _t([1.0]), 0.0, 1.0,
                          rtol=1e-10, atol=1e-12)
    sol(1.0)[0].backward()
    assert abs(float(lam.grad) + np.exp(-0.7)) < 1e-6
    sol, _ = odeint_dense(f, _t([1.0]), 0.0, 2.0, rtol=1e-10, atol=1e-12)
    t = torch.tensor(1.1, dtype=torch.float64, requires_grad=True)
    sol(t)[0].backward()
    assert abs(float(t.grad) + np.exp(-1.1)) < 1e-5


def test_dense_unknown_option_raises():
    with pytest.raises(ValueError, match="unknown odeint_dense options"):
        odeint_dense(f, torch.ones(1, dtype=torch.float64), 0.0, 1.0,
                     options={"bogus": 1})
    with pytest.raises(ValueError, match="adaptive method"):
        odeint_dense(f, torch.ones(1, dtype=torch.float64), 0.0, 1.0,
                     method="rk4")
