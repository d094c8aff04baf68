"""The FitzHugh-Nagumo theta-field on the port's fused adaptive engine
(the plain versions of its K2 and K3) against the JAX package's
registration (`ops/fhn_dopri5.py`), run in interpret mode on the same
numpy inputs, with theta carried over by `params_from_numpy`.

Gates, at rtol=1e-5 / atol=1e-7 in float32: trajectories within
1e-4 * max|y| and step counts as `torch_parity.check_solve` says; the
replay gradient within 1e-3 max-rel of `jax.grad` through the JAX engine
(the JAX package's float32 gate for its own fused adjoint; max-rel of the
parameters as one vector, `torch_parity.tree_max_rel`), and within
1e-5 of autograd through the port's plain forward on the same step mesh
(measured 5.8e-7 at the card test's shape); potentials to 1e-4 relative
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

from bayesian_ode_tpu.ops import fhn_dopri5 as jf
from bayesian_ode_tpu_torch.experiments import run_sampler
from bayesian_ode_tpu_torch.models import fhn_inference
from bayesian_ode_tpu_torch.ops import fhn_dopri5 as tf
from bayesian_ode_tpu_torch.ops.fused_field import (
    fused_dopri5_trajectory_plain,
)
from torch_parity import (  # noqa: F401
    FIELD_T,
    FIELD_X0,
    check_solve,
    fhn_theta,
    field_outputs,
    max_rel,
    one_torch_thread,
    to_np,
    tree_max_rel,
)

TOL = {"rtol": 1e-5, "atol": 1e-7}


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's solve, gradient and potential, once per module."""
    theta = fhn_theta()
    W, Y = field_outputs()
    jt = {k: jnp.asarray(v) for k, v in theta.items()}
    x0, ts = jnp.asarray(FIELD_X0), jnp.asarray(FIELD_T)
    ys, st = jf.fhn_dopri5_solve_stats(jt, x0, ts, interpret=True, **TOL)
    grad = jax.grad(lambda p: jnp.sum(jf.fhn_dopri5_trajectory(
        p, x0, ts, interpret=True, **TOL) * W))(jt)
    pot = jf.make_fused_fhn_potential_dopri5(x0, ts, Y, noise=0.1,
                                             interpret=True, **TOL)
    return {"theta": theta, "W": W, "Y": Y, "ys": ys, "st": st,
            "grad": grad, "pot": pot(jt),
            "pgrad": jax.grad(lambda p: jnp.sum(pot(p)))(jt)}


def _theta(ref):
    return {k: v.requires_grad_(True) for k, v in
            fhn_inference.params_from_numpy(ref["theta"]).items()}


def _x0_ts():
    return torch.tensor(FIELD_X0), torch.tensor(FIELD_T)


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_forward_and_step_counts_match_jax(ref, method):
    theta = _theta(ref)
    if method == "dopri5":
        ys_j, st_j = ref["ys"], ref["st"]
    else:
        ys_j, st_j = jf.fhn_dopri5_solve_stats(
            {k: jnp.asarray(v) for k, v in ref["theta"].items()},
            jnp.asarray(FIELD_X0), jnp.asarray(FIELD_T), interpret=True,
            method="tsit5", **TOL)
    ys, st = tf.fhn_dopri5_solve_stats(theta, *_x0_ts(), method=method,
                                       **TOL)
    check_solve(ys, st, ys_j, st_j)
    assert torch.equal(st["n_iterations"], st["n_accepted"])


def test_replay_gradient_matches_jax_grad(ref):
    theta = _theta(ref)
    ys = tf.fhn_dopri5_trajectory(theta, *_x0_ts(), **TOL)
    (ys * torch.tensor(ref["W"])).sum().backward()
    assert tree_max_rel({k: v.grad for k, v in theta.items()},
                        ref["grad"]) <= 1e-3


def test_replay_matches_autograd_of_the_plain_forward(ref):
    W = torch.tensor(ref["W"])
    grads = []
    for plain in (False, True):
        theta = _theta(ref)
        w = (theta["a"], theta["b"], theta["c"])
        if plain:
            ys = fused_dopri5_trajectory_plain(tf.fhn_field(), w, *_x0_ts(),
                                               **TOL)
        else:
            ys = tf.fhn_dopri5_trajectory(theta, *_x0_ts(), **TOL)
        grads.append(torch.autograd.grad((ys * W).sum(), w))
    for a, b in zip(*grads):
        assert max_rel(a, b) <= 1e-5


def test_potential_matches_jax(ref):
    theta = _theta(ref)
    pot = tf.make_fused_fhn_potential_dopri5(*_x0_ts(),
                                             torch.tensor(ref["Y"]),
                                             noise=0.1, **TOL)
    val = pot(theta)
    val.sum().backward()
    assert val.shape == (128,) and val.dtype == torch.float32
    np.testing.assert_allclose(to_np(val), np.asarray(ref["pot"]),
                               rtol=1e-4)
    assert tree_max_rel({k: v.grad for k, v in theta.items()},
                        ref["pgrad"]) <= 1e-3


def test_field_and_potential_of_the_model_match_jax():
    """`models.fhn_inference`: the field at theta and the one-chain
    potential through a solve, in float64."""
    from bayesian_ode_tpu.models import fhn_inference as jfi
    from bayesian_ode_tpu_torch.ode import odeint

    x = np.random.RandomState(0).randn(7, 2)
    theta = {"a": 0.25, "b": 0.15, "c": 2.8}
    want = np.asarray(jfi.vector_field(theta, 0.0, jnp.asarray(x)))
    got = fhn_inference.vector_field(
        {k: torch.tensor(v, dtype=torch.float64) for k, v in theta.items()},
        0.0, torch.tensor(x))
    np.testing.assert_allclose(to_np(got), want, rtol=1e-12)
    th0 = fhn_inference.init_theta()
    assert {k: float(v) for k, v in th0.items()} == jfi.TRUE_THETA
    f64 = torch.float64
    x0 = FIELD_X0.astype(np.float64)
    ts = FIELD_T.astype(np.float64)
    _, Y = field_outputs()
    pot = fhn_inference.make_potential(
        torch.tensor(x0), torch.tensor(ts), torch.tensor(Y, dtype=f64),
        lambda f, y0, t: odeint(f, y0, t, 1e-9, 1e-11), noise=0.1)
    exact = fhn_inference.make_potential(
        torch.tensor(x0), torch.tensor(ts), torch.tensor(Y, dtype=f64),
        lambda f, y0, t: odeint(f, y0, t, 1e-9, 1e-11), noise=0.1,
        add_prior=False)
    th = {k: torch.tensor(v, dtype=torch.float64) for k, v in theta.items()}
    prior = 0.5 * ((0.25 - 0.0) ** 2 + (0.15 - 0.0) ** 2 + (2.8 - 3.0) ** 2)
    assert abs(float(pot(th) - exact(th)) - prior) <= 1e-9 * prior


def test_driver_runs_fhn_at_dopri5(tmp_path):
    """run_sampler(model="fhn", solver="dopri5") on the CPU: theta starts
    at the truth, the diagnostics read the last leaf (c), as the JAX
    driver's do."""
    _, Y = field_outputs()
    data = {"x0": FIELD_X0, "t": FIELD_T, "Y": Y, "noise": 0.1}
    cfg = {"method": "SGLD", "inf_type": "sampler", "id": 1,
           "burn_in": 1, "num_samples": 4, "thinning": 1, "num_chains": 100,
           "lr0": 1e-6, "lr_gamma": 0.55, "lr_t0": 100, "lr_alpha": 1.0,
           "engine": "fused", "solver": "dopri5", "model": "fhn", "seed": 0,
           **TOL}
    summary = run_sampler(cfg, data, str(tmp_path), make_plots=False,
                          device="cpu")
    assert summary["num_chains"] == 128 and summary["kept_samples"] == 4
    assert np.isfinite(summary["min_potential"])
    assert len(summary["ess_logsn"]) == 1
    chain = np.load(tmp_path / "SGLD" / "1" / "chain.npz")
    assert list(chain["__keys__"]) == ["a", "b", "c"]
    assert chain["leaf_2"].shape == (128, 4)
