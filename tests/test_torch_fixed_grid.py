"""Parity of the port's fixed-grid `odeint` (euler, midpoint, rk4) with the
JAX package's, in float64.  The same algorithm in the same operation order
on the same grid: gated at 1e-12 * max|y|."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.models.dynamics import DYNAMICS as JDYNAMICS
from bayesian_ode_tpu.ode.odeint import odeint_with_stats as jodeint_stats
from bayesian_ode_tpu_torch import odeint, odeint_with_stats
from bayesian_ode_tpu_torch.models.dynamics import DYNAMICS as TDYNAMICS
from torch_parity import one_torch_thread, to_np  # noqa: F401


def _both(method, options=None, T=25, t_max=3.0):
    x0 = 1.5 * np.random.RandomState(0).randn(5, 2)
    t = np.linspace(0.0, t_max, T)
    yj, sj = jodeint_stats(JDYNAMICS["vdp"], jnp.asarray(x0), jnp.asarray(t),
                           method=method, options=options)
    yt, st = odeint_with_stats(TDYNAMICS["vdp"], torch.tensor(x0),
                               torch.tensor(t), method=method,
                               options=options)
    return np.asarray(yj), sj, yt, st


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("options", [None, {"step_size": 0.07},
                                     {"compensated": True}])
def test_fixed_grid_matches_jax_f64(method, options):
    yj, sj, yt, st = _both(method, options)
    assert yt.dtype == torch.float64 and tuple(yt.shape) == yj.shape
    assert np.max(np.abs(to_np(yt) - yj)) <= 1e-12 * np.max(np.abs(yj))
    for key in ("nfe", "n_accepted", "n_rejected"):
        assert int(st[key]) == int(sj[key]), key
    assert bool(st["reached_final_time"])


def test_fixed_grid_batched_systems_match_one_by_one():
    x0 = torch.tensor(1.5 * np.random.RandomState(1).randn(3, 5, 2))
    t = torch.linspace(0.0, 2.5, 12, dtype=torch.float64)
    f = TDYNAMICS["vdp"]
    ys, st = odeint_with_stats(lambda tt, y: f(tt, y), x0, t, method="rk4",
                               batched=True)
    assert st["nfe"].shape == (3,) and int(st["nfe"][0]) == 4 * 11
    for b in range(3):
        torch.testing.assert_close(ys[:, b], odeint(f, x0[b], t,
                                                    method="rk4"),
                                   rtol=0, atol=0)


def test_unported_methods_and_options_raise():
    """Every method of the JAX registry runs (adams among them), and an
    option the method does not read is ignored, as the JAX package's
    solvers ignore it; an unknown method still raises."""
    x0, t = torch.tensor([1.5, -0.5], dtype=torch.float64), \
        torch.linspace(0, 1, 3, dtype=torch.float64)
    f = TDYNAMICS["vdp"]
    ys_j = jodeint_stats(JDYNAMICS["vdp"], jnp.asarray(to_np(x0)),
                         jnp.asarray(to_np(t)), method="adams")[0]
    np.testing.assert_allclose(to_np(odeint(f, x0, t, method="adams")),
                               np.asarray(ys_j), rtol=1e-8, atol=1e-10)
    torch.testing.assert_close(
        odeint(f, x0, t, method="rk4", options={"perturb": True}),
        odeint(f, x0, t, method="rk4"), rtol=0, atol=0)
    torch.testing.assert_close(
        odeint(f, x0, t, method="dopri5", options={"step_size": 0.1}),
        odeint(f, x0, t, method="dopri5"), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown method"):
        odeint(f, x0, t, method="rk45")
