"""The MLP field on the port's fused adaptive engine (the plain versions
of its K2 and K3) against the JAX package's registration
(`ops/mlp_dopri5.py`), run in interpret mode on the same numpy inputs,
with the layer list carried over by `models.mlp.params_from_numpy`.

Gates, at rtol=1e-5 / atol=1e-7 in float32: trajectories within
1e-4 * max|y| and step counts as `torch_parity.check_solve` says; the
replay gradient within 1e-3 max-rel of `jax.grad` through the JAX engine
(the JAX package's float32 gate for its own fused adjoint; max-rel of the
parameters as one vector, `torch_parity.tree_max_rel`), and within
1e-5 of autograd through the port's plain forward on the same step mesh
(measured 5.2e-7 at the card test's shape); potentials to 1e-4 relative
and their gradients to 1e-3 max-rel.  Both packages' gradients are
frozen-step-mesh gradients of their own float32 step meshes: on MLP
inputs with N(0, 0.1) biases each was about 1e-3 max-rel per leaf from a
float64 truth at rtol=1e-5 (measured: JAX 1.3e-3, the port 2.1e-3).
The same gates hold at the shapes past one warp of the card's kernels
(csrc/mlp_wide_field.cuh): H = 66 at N = 2 and N = 17 at H = 4, start
points on two lines, one module-scoped JAX reference each.  There the
replay gradient is held against JAX's through the potential's gradient
(1e-3) and, for the random cotangent W, against autograd through the
port's plain forward on its own step mesh (1e-5): at H = 66 the two
packages' W-gradients are 1.9e-3 apart (measured), 1.4e-3 (the port)
and 2.6e-3 (JAX) from the port's plain gradient at rtol=1e-10, so there
the file's 1e-3 gate between them would measure the step meshes, not the
field.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ops import mlp_dopri5 as jm
from bayesian_ode_tpu_torch.experiments import run_sampler
from bayesian_ode_tpu_torch.models import mlp
from bayesian_ode_tpu_torch.ops import mlp_dopri5 as tm
from bayesian_ode_tpu_torch.ops.fused_field import (
    fused_dopri5_trajectory_plain,
)
from torch_parity import (  # noqa: F401
    FIELD_T,
    FIELD_X0,
    check_solve,
    field_outputs,
    max_rel,
    mlp_params,
    one_torch_thread,
    to_np,
    tree_max_rel,
)

TOL = {"rtol": 1e-5, "atol": 1e-7}


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's solve, gradient and potential, once per module."""
    params = mlp_params()
    W, Y = field_outputs()
    jp = jax.tree.map(jnp.asarray, params)
    x0, ts = jnp.asarray(FIELD_X0), jnp.asarray(FIELD_T)
    ys, st = jm.mlp_dopri5_solve_stats(jp, x0, ts, interpret=True, **TOL)
    grad = jax.grad(lambda p: jnp.sum(jm.mlp_dopri5_trajectory(
        p, x0, ts, interpret=True, **TOL) * W))(jp)
    pot = jm.make_fused_mlp_potential_dopri5(x0, ts, Y, reg=0.5,
                                             interpret=True, **TOL)
    return {"params": params, "W": W, "Y": Y, "ys": ys, "st": st,
            "grad": grad, "pot": pot(jp),
            "pgrad": jax.grad(lambda p: jnp.sum(pot(p)))(jp)}


def _params(ref):
    return [{k: v.requires_grad_(True) for k, v in layer.items()}
            for layer in mlp.params_from_numpy(ref["params"])]


def _grads(params):
    return [{k: v.grad for k, v in layer.items()} for layer in params]


def _x0_ts():
    return torch.tensor(FIELD_X0), torch.tensor(FIELD_T)


def test_forward_and_step_counts_match_jax(ref):
    ys, st = tm.mlp_dopri5_solve_stats(_params(ref), *_x0_ts(), **TOL)
    check_solve(ys, st, ref["ys"], ref["st"])


def test_replay_gradient_matches_jax_grad(ref):
    params = _params(ref)
    ys = tm.mlp_dopri5_trajectory(params, *_x0_ts(), **TOL)
    (ys * torch.tensor(ref["W"])).sum().backward()
    assert tree_max_rel(_grads(params), ref["grad"]) <= 1e-3


def test_replay_matches_autograd_of_the_plain_forward(ref):
    W = torch.tensor(ref["W"])
    grads = []
    for plain in (False, True):
        params = _params(ref)
        w = tuple(layer[k] for layer in params for k in ("w", "b"))
        if plain:
            ys = fused_dopri5_trajectory_plain(tm.mlp_field(6), w,
                                               *_x0_ts(), **TOL)
        else:
            ys = tm.mlp_dopri5_trajectory(params, *_x0_ts(), **TOL)
        grads.append(torch.autograd.grad((ys * W).sum(), w))
    for a, b in zip(*grads):
        assert max_rel(a, b) <= 1e-5


def test_potential_matches_jax(ref):
    params = _params(ref)
    pot = tm.make_fused_mlp_potential_dopri5(*_x0_ts(),
                                             torch.tensor(ref["Y"]),
                                             reg=0.5, **TOL)
    val = pot(params)
    val.sum().backward()
    assert val.shape == (128,) and val.dtype == torch.float32
    np.testing.assert_allclose(to_np(val), np.asarray(ref["pot"]),
                               rtol=1e-4)
    assert tree_max_rel(_grads(params), ref["pgrad"]) <= 1e-3


def test_record_overflow_raises(ref):
    with pytest.raises(RuntimeError, match="store_steps"):
        tm.mlp_dopri5_trajectory(_params(ref), *_x0_ts(), store_steps=2,
                                 **TOL)


def test_driver_runs_nn_at_dopri5(tmp_path):
    """run_sampler(model="nn", solver="dopri5") under pSGLD on the CPU
    (BASELINE config 3 on the adaptive engine): the MLP's layer list in
    chain.npz, the diagnostics from the last leaf (b3), as the JAX
    driver's."""
    _, Y = field_outputs()
    data = {"x0": FIELD_X0, "t": FIELD_T, "Y": Y, "noise": 0.1}
    cfg = {"method": "pSGLD", "inf_type": "sampler", "id": 1,
           "burn_in": 1, "num_samples": 4, "thinning": 1, "num_chains": 100,
           "lr0": 1e-4, "lr_gamma": 0.55, "lr_t0": 100, "lr_alpha": 1.0,
           "psgld_alpha": 0.99, "lambda_": 1e-8, "engine": "fused",
           "solver": "dopri5", "model": "nn", "hidden": 6, "seed": 0,
           **TOL}
    summary = run_sampler(cfg, data, str(tmp_path), make_plots=False,
                          device="cpu")
    assert summary["num_chains"] == 128 and summary["kept_samples"] == 4
    assert np.isfinite(summary["min_potential"])
    assert np.isfinite(summary["ess_logsn"]).all()
    # leaves of each layer in sorted key order: b, w
    chain = np.load(tmp_path / "pSGLD" / "1" / "chain.npz")
    assert chain["leaf_3"].shape == (128, 4, 6, 6)
    assert np.isfinite(np.load(tmp_path / "pSGLD" / "1"
                               / "total_loss_arr.npy")).all()


# (N, H) past one warp: the parameter's name, for the test ids
WIDE = {"N2-H66": (2, 66), "N17-H4": (17, 4)}


@pytest.fixture(scope="module", params=list(WIDE))
def wide_ref(request):
    """The JAX engine's solve, gradient and potential at a shape past one
    warp: N start points on two lines (the JAX package's wide fused case),
    the 8 output times to t = 2 of the other cases."""
    N, H = WIDE[request.param]
    params = mlp_params(H=H)
    x0 = np.stack([np.linspace(-1.5, 2.0, N), np.linspace(0.8, -0.9, N)],
                  axis=-1).astype(np.float32)
    W, Y = field_outputs(N=N)
    jp = jax.tree.map(jnp.asarray, params)
    jx0, ts = jnp.asarray(x0), jnp.asarray(FIELD_T)
    ys, st = jm.mlp_dopri5_solve_stats(jp, jx0, ts, interpret=True, **TOL)
    pot = jm.make_fused_mlp_potential_dopri5(jx0, ts, Y, reg=0.5,
                                             interpret=True, **TOL)
    return {"params": params, "H": H, "x0": x0, "W": W, "Y": Y, "ys": ys,
            "st": st, "pot": pot(jp),
            "pgrad": jax.grad(lambda p: jnp.sum(pot(p)))(jp)}


def test_forward_past_one_warp_matches_jax(wide_ref):
    ys, st = tm.mlp_dopri5_solve_stats(_params(wide_ref),
                                       torch.tensor(wide_ref["x0"]),
                                       torch.tensor(FIELD_T), **TOL)
    check_solve(ys, st, wide_ref["ys"], wide_ref["st"])


def test_replay_past_one_warp_matches_autograd_of_the_plain_forward(
        wide_ref):
    W = torch.tensor(wide_ref["W"])
    x0, ts = torch.tensor(wide_ref["x0"]), torch.tensor(FIELD_T)
    grads = []
    for plain in (False, True):
        params = _params(wide_ref)
        w = tuple(layer[k] for layer in params for k in ("w", "b"))
        if plain:
            ys = fused_dopri5_trajectory_plain(tm.mlp_field(wide_ref["H"]),
                                               w, x0, ts, **TOL)
        else:
            ys = tm.mlp_dopri5_trajectory(params, x0, ts, **TOL)
        grads.append(torch.autograd.grad((ys * W).sum(), w))
    for a, b in zip(*grads):
        assert max_rel(a, b) <= 1e-5


def test_potential_past_one_warp_matches_jax(wide_ref):
    params = _params(wide_ref)
    pot = tm.make_fused_mlp_potential_dopri5(
        torch.tensor(wide_ref["x0"]), torch.tensor(FIELD_T),
        torch.tensor(wide_ref["Y"]), reg=0.5, **TOL)
    val = pot(params)
    val.sum().backward()
    assert val.shape == (128,) and val.dtype == torch.float32
    np.testing.assert_allclose(to_np(val), np.asarray(wide_ref["pot"]),
                               rtol=1e-4)
    assert tree_max_rel(_grads(params), wide_ref["pgrad"]) <= 1e-3


def test_driver_runs_nn_at_dopri5_past_one_warp(tmp_path):
    """run_sampler(model="nn", hidden=40, engine="fused",
    solver="dopri5") under pSGLD on the CPU: H = 40 is past one warp of
    the card's kernels (two hidden units a lane there)."""
    _, Y = field_outputs()
    data = {"x0": FIELD_X0, "t": FIELD_T, "Y": Y, "noise": 0.1}
    cfg = {"method": "pSGLD", "inf_type": "sampler", "id": 1,
           "burn_in": 1, "num_samples": 3, "thinning": 1, "num_chains": 100,
           "lr0": 1e-4, "lr_gamma": 0.55, "lr_t0": 100, "lr_alpha": 1.0,
           "psgld_alpha": 0.99, "lambda_": 1e-8, "engine": "fused",
           "solver": "dopri5", "model": "nn", "hidden": 40, "seed": 0,
           **TOL}
    summary = run_sampler(cfg, data, str(tmp_path), make_plots=False,
                          device="cpu")
    assert summary["num_chains"] == 128 and summary["kept_samples"] == 3
    assert np.isfinite(summary["min_potential"])
    chain = np.load(tmp_path / "pSGLD" / "1" / "chain.npz")
    assert chain["leaf_3"].shape == (128, 3, 40, 40)
    assert np.isfinite(np.load(tmp_path / "pSGLD" / "1"
                               / "total_loss_arr.npy")).all()
