"""The spiral y^3-net field on the port's fused adaptive engine (the
plain versions of its K2 and K3) against the JAX package's registration
(`ops/spiral_dopri5.py`), run in interpret mode on the same numpy inputs,
with the weights carried over by `models.spiral.params_from_numpy`.

Gates, at rtol=1e-5 / atol=1e-7 in float32: trajectories within
1e-4 * max|y| and step counts as `torch_parity.check_solve` says; the
replay gradient within 1e-3 max-rel of `jax.grad` through the JAX engine
(the JAX package's float32 gate for its own fused adjoint; max-rel of the
parameters as one vector, `torch_parity.tree_max_rel`), and within
1e-5 of autograd through the port's plain forward on the same step mesh
(measured 3.9e-7 at the card test's shape); potentials to 1e-4 relative
and their gradients to 1e-3 max-rel.  Both packages' gradients are
frozen-step-mesh gradients of their own float32 step meshes: on MLP
inputs with N(0, 0.1) biases each was about 1e-3 max-rel per leaf from a
float64 truth at rtol=1e-5 (measured: JAX 1.3e-3, the port 2.1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.models import spiral as jspiral
from bayesian_ode_tpu.ops import spiral_dopri5 as js
from bayesian_ode_tpu_torch.experiments import run_sampler
from bayesian_ode_tpu_torch.models import spiral
from bayesian_ode_tpu_torch.ops import spiral_dopri5 as ts_
from bayesian_ode_tpu_torch.ops.fused_field import (
    fused_dopri5_trajectory_plain,
)
from torch_parity import (  # noqa: F401
    FIELD_T,
    FIELD_X0,
    check_solve,
    field_outputs,
    max_rel,
    one_torch_thread,
    spiral_params,
    to_np,
    tree_max_rel,
)

TOL = {"rtol": 1e-5, "atol": 1e-7}
KEYS = ("w1", "b1", "w2", "b2")


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's solve, gradient and potential, once per module."""
    params = spiral_params()
    W, Y = field_outputs()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    x0, ts = jnp.asarray(FIELD_X0), jnp.asarray(FIELD_T)
    ys, st = js.spiral_dopri5_solve_stats(jp, x0, ts, interpret=True, **TOL)
    grad = jax.grad(lambda p: jnp.sum(js.spiral_dopri5_trajectory(
        p, x0, ts, interpret=True, **TOL) * W))(jp)
    pot = js.make_fused_spiral_potential_dopri5(x0, ts, Y, reg=0.5,
                                                interpret=True, **TOL)
    return {"params": params, "W": W, "Y": Y, "ys": ys, "st": st,
            "grad": grad, "pot": pot(jp),
            "pgrad": jax.grad(lambda p: jnp.sum(pot(p)))(jp)}


def _params(ref):
    return {k: v.requires_grad_(True) for k, v in
            spiral.params_from_numpy(ref["params"]).items()}


def _x0_ts():
    return torch.tensor(FIELD_X0), torch.tensor(FIELD_T)


def test_forward_and_step_counts_match_jax(ref):
    ys, st = ts_.spiral_dopri5_solve_stats(_params(ref), *_x0_ts(), **TOL)
    check_solve(ys, st, ref["ys"], ref["st"])


def test_replay_gradient_matches_jax_grad(ref):
    params = _params(ref)
    ys = ts_.spiral_dopri5_trajectory(params, *_x0_ts(), **TOL)
    (ys * torch.tensor(ref["W"])).sum().backward()
    assert tree_max_rel({k: v.grad for k, v in params.items()},
                        ref["grad"]) <= 1e-3


def test_replay_matches_autograd_of_the_plain_forward(ref):
    W = torch.tensor(ref["W"])
    grads = []
    for plain in (False, True):
        params = _params(ref)
        w = tuple(params[k] for k in KEYS)
        if plain:
            ys = fused_dopri5_trajectory_plain(ts_.spiral_field(), w,
                                               *_x0_ts(), **TOL)
        else:
            ys = ts_.spiral_dopri5_trajectory(params, *_x0_ts(), **TOL)
        grads.append(torch.autograd.grad((ys * W).sum(), w))
    for a, b in zip(*grads):
        assert max_rel(a, b) <= 1e-5


def test_potential_matches_jax(ref):
    params = _params(ref)
    pot = ts_.make_fused_spiral_potential_dopri5(*_x0_ts(),
                                                 torch.tensor(ref["Y"]),
                                                 reg=0.5, **TOL)
    val = pot(params)
    val.sum().backward()
    assert val.shape == (128,) and val.dtype == torch.float32
    np.testing.assert_allclose(to_np(val), np.asarray(ref["pot"]),
                               rtol=1e-4)
    assert tree_max_rel({k: v.grad for k, v in params.items()},
                        ref["pgrad"]) <= 1e-3


def test_model_matches_jax():
    """`models.spiral`: the true field and the learned field in float64,
    and the initial weights' shapes and scale."""
    rng = np.random.RandomState(1)
    y = rng.randn(7, 2)
    p = {"w1": rng.randn(2, 5), "b1": rng.randn(5), "w2": rng.randn(5, 2),
         "b2": rng.randn(2)}
    want = np.asarray(jspiral.vector_field(
        jax.tree.map(jnp.asarray, p), 0.0, jnp.asarray(y)))
    got = spiral.vector_field(spiral.params_from_numpy(p), 0.0,
                              torch.tensor(y))
    np.testing.assert_allclose(to_np(got), want, rtol=1e-12)
    np.testing.assert_allclose(
        to_np(spiral.true_field(0.0, torch.tensor(y))),
        np.asarray(jspiral.true_field(0.0, jnp.asarray(y))), rtol=1e-12)
    p0 = spiral.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p0.items()} == {
        "w1": (2, 50), "b1": (50,), "w2": (50, 2), "b2": (2,)}
    assert not p0["b1"].any() and not p0["b2"].any()
    assert 0.05 < float(p0["w1"].std()) < 0.2


def test_driver_runs_spiral_at_dopri5(tmp_path):
    """run_sampler(model="spiral", solver="dopri5") under pSGLD on the
    CPU: the diagnostics read the first two coordinates of the last leaf
    (w2), the JAX driver's NN quirk, kept."""
    _, Y = field_outputs()
    data = {"x0": FIELD_X0, "t": FIELD_T, "Y": Y, "noise": 0.1}
    cfg = {"method": "pSGLD", "inf_type": "sampler", "id": 1,
           "burn_in": 1, "num_samples": 4, "thinning": 1, "num_chains": 100,
           "lr0": 1e-5, "lr_gamma": 0.55, "lr_t0": 100, "lr_alpha": 1.0,
           "psgld_alpha": 0.99, "lambda_": 1e-8, "engine": "fused",
           "solver": "dopri5", "model": "spiral", "hidden": 6, "seed": 0,
           **TOL}
    summary = run_sampler(cfg, data, str(tmp_path), make_plots=False,
                          device="cpu")
    assert summary["num_chains"] == 128 and summary["kept_samples"] == 4
    assert np.isfinite(summary["min_potential"])
    assert len(summary["ess_logsn"]) == 2
    chain = np.load(tmp_path / "pSGLD" / "1" / "chain.npz")
    assert list(chain["__keys__"]) == ["b1", "b2", "w1", "w2"]
    assert chain["leaf_3"].shape == (128, 4, 6, 2)
