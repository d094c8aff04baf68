"""Parity of the port's forward sensitivities (`ode/sensitivity.py`)
with JAX `jacfwd` through the solver, and of the spiral demo's training
helpers (`models/spiral.py`: `get_batch`, `make_loss` through
`odeint_adjoint`) with the JAX package's, in float64 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import odeint_adjoint as jadjoint
from bayesian_ode_tpu.models import spiral as jspiral
from bayesian_ode_tpu.ode.sensitivity import (
    odeint_forward_sensitivity as jsens,
)
from bayesian_ode_tpu_torch.models import spiral as tspiral
from bayesian_ode_tpu_torch.ode import (
    odeint,
    odeint_adjoint,
    odeint_forward_sensitivity,
)
from torch_parity import max_rel, one_torch_thread, to_np  # noqa: F401

H = 8
TOL = {"rtol": 1e-7, "atol": 1e-9}


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "rk4"])
def test_forward_sensitivity_matches_jacfwd(method):
    y0, t = np.array([1.5, -0.5]), np.linspace(0.0, 3.0, 6)
    p = {"a": np.array(0.8), "b": np.array([0.3, 0.1])}

    def jf(t, y, p):
        return jnp.stack([y[1], p["a"] * (1 - y[0] ** 2) * y[1] - y[0]
                          + p["b"][0]]) * (1 + p["b"][1])

    def tf(t, y, p):
        return torch.stack([y[1], p["a"] * (1 - y[0] ** 2) * y[1] - y[0]
                            + p["b"][0]]) * (1 + p["b"][1])

    ys_j, s_j = jsens(jf, jnp.asarray(y0), jnp.asarray(t),
                      jax.tree.map(jnp.asarray, p), method=method)
    ys, s = odeint_forward_sensitivity(
        tf, torch.tensor(y0), torch.tensor(t),
        {k: torch.tensor(v) for k, v in p.items()}, method=method)
    np.testing.assert_allclose(to_np(ys), np.asarray(ys_j), rtol=1e-10)
    for k in p:
        assert s[k].shape == s_j[k].shape
        np.testing.assert_allclose(to_np(s[k]), np.asarray(s_j[k]),
                                   rtol=1e-8, atol=1e-10)


def test_spiral_get_batch_and_make_loss_gradient():
    """get_batch's sub-trajectories, and make_loss's gradient through
    odeint_adjoint on the same minibatch against the JAX package's."""
    t = np.linspace(0.0, 5.0, 40)
    true_y = to_np(odeint(tspiral.true_field,
                          torch.tensor(tspiral.TRUE_Y0), torch.tensor(t)))
    by0, bt, by = tspiral.get_batch(torch.Generator().manual_seed(0),
                                    torch.tensor(true_y), torch.tensor(t),
                                    batch_time=6, batch_size=5)
    assert by0.shape == (5, 2) and bt.shape == (6,) and by.shape == (6, 5, 2)
    s = [int(np.where((true_y == to_np(r)).all(axis=1))[0][0]) for r in by0]
    assert len(set(s)) == 5
    for i in range(6):
        np.testing.assert_array_equal(to_np(by[i]), true_y[np.array(s) + i])

    params = jspiral.init_params(jax.random.PRNGKey(0), hidden=H)
    jloss = jspiral.make_loss(
        lambda f, y0, tt: jadjoint(f, y0, tt, **TOL), jnp.asarray(to_np(by0)),
        jnp.asarray(to_np(bt)), jnp.asarray(to_np(by)))
    g_j = jax.grad(jloss)(params)
    tp = tspiral.params_from_numpy(jax.tree.map(np.asarray, params))
    for v in tp.values():
        v.requires_grad_(True)
    leaves = [tp[k] for k in ("b1", "b2", "w1", "w2")]
    tloss = tspiral.make_loss(
        lambda f, y0, tt: odeint_adjoint(f, y0, tt, **TOL,
                                         adjoint_params=leaves),
        by0, bt, by)
    loss = tloss(tp)
    np.testing.assert_allclose(float(loss.detach()), float(jloss(params)),
                               rtol=1e-9)
    loss.backward()
    for k in tp:
        assert max_rel(tp[k].grad, g_j[k]) <= 1e-6
