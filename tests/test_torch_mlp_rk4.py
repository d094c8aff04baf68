"""Parity of the port's fused rk4 MLP engine (plain versions of kernels K6
and K7) and of its MLP model with the JAX package, the Pallas kernels run
in interpret mode.

Gates as for the GP engine (tests/test_torch_gp_rk4.py): trajectories in
float32 to 1e-5 * max|y| (measured 1.2e-3 at max|y| 3.2e3 over 60 steps
from the uniform(-0.5, 0.5) initialization), each weight cotangent and
x0's to 1e-5 max-rel against jax.vjp of the kernel (measured 8.4e-7),
the plain backward against autograd through the plain forward in float64
to 1e-10, and potentials, value and gradient, to 1e-5 relative.  The
generic MLP field and potential match in float64 to 1e-12.  Besides the
GP problem's 5 trajectories at H = 8 and 20, the shapes past one warp of
the card's kernels (csrc/mlp_wide_field.cuh): H = 66 at N = 2 (three
hidden units a lane) and N = 17 at H = 4 (one trajectory point a lane),
8 output times to t = 2, start points on two lines.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import odeint as jodeint
from bayesian_ode_tpu.models import mlp as jmlp
from bayesian_ode_tpu.ops.mlp_rk4 import (
    make_fused_mlp_potential as jmake_potential,
)
from bayesian_ode_tpu.ops.mlp_rk4 import mlp_rk4_trajectory as jtrajectory
from bayesian_ode_tpu_torch import odeint as todeint
from bayesian_ode_tpu_torch.experiments import run_sampler
from bayesian_ode_tpu_torch.models import mlp as tmlp
from bayesian_ode_tpu_torch.ops import mlp_rk4 as tm
from torch_parity import (  # noqa: F401
    gp_problem,
    max_rel,
    one_torch_thread,
    to_np,
)

C = 128


def _layers(H, C=C, seed=0):
    """A chain-batched layer list in numpy: uniform(-0.5, 0.5) weights as
    the initialization draws them, small random biases."""
    rng = np.random.RandomState(seed)
    sizes = [2, H, H, 2]
    return [{"w": rng.uniform(-0.5, 0.5, (C, a, b)).astype(np.float32),
             "b": (0.1 * rng.randn(C, b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


@pytest.fixture(scope="module")
def data():
    p = gp_problem(C=1)
    return {k: p[k] for k in ("x0", "t", "Y")}


# (N, H) past one warp: the parameter's name, for the test ids
WIDE = {"N2-H66": (2, 66), "N17-H4": (17, 4)}


def _wide_data(N):
    """N start points on two lines (the JAX package's wide fused case), 8
    output times to t = 2, seeded observations."""
    x0 = np.stack([np.linspace(-1.5, 2.0, N), np.linspace(0.8, -0.9, N)],
                  axis=-1).astype(np.float32)
    t = np.linspace(0.0, 2.0, 8).astype(np.float32)
    Y = np.random.RandomState(N).randn(N, 8, 2).astype(np.float32)
    return {"x0": x0, "t": t, "Y": Y}


@pytest.fixture(scope="module", params=[8, 20, *WIDE])
def case(request, data):
    """The JAX kernel's trajectories and their vjp for a seeded
    cotangent, at hidden width H (the GP problem's data) or at a shape
    past one warp."""
    if request.param in WIDE:
        N, H = WIDE[request.param]
        data = _wide_data(N)
    else:
        H = request.param
    layers = _layers(H)
    ts = jnp.asarray(data["t"])

    def traj(params, x0):
        return jtrajectory(params, x0, ts, tile=128, interpret=True)

    jparams = jax.tree.map(jnp.asarray, layers)
    ys, vjp = jax.vjp(traj, jparams, jnp.asarray(data["x0"]))
    g = np.random.RandomState(5).randn(*ys.shape).astype(np.float32)
    wbar, x0bar = vjp(jnp.asarray(g))
    return {"H": H, "layers": layers, "ys": np.asarray(ys), "g": g,
            "wbar": jax.tree.map(np.asarray, wbar),
            "x0bar": np.asarray(x0bar), "data": data}


def _w(layers, dtype=torch.float32):
    return tm._flat(tmlp.params_from_numpy(layers, dtype=dtype))


def _dts(data, dtype=torch.float32):
    return torch.diff(torch.tensor(data["t"])).to(dtype)


def test_plain_forward_matches_the_jax_kernel(case):
    data = case["data"]
    ys = tm.mlp_rk4_fwd_plain(_w(case["layers"]), torch.tensor(data["x0"]),
                              _dts(data))
    ys_j = case["ys"]
    assert ys.dtype == torch.float32 and tuple(ys.shape) == ys_j.shape
    assert np.max(np.abs(to_np(ys) - ys_j)) <= 1e-5 * np.max(np.abs(ys_j))


def test_plain_backward_matches_the_jax_vjp(case):
    data = case["data"]
    w = _w(case["layers"])
    x0 = torch.tensor(data["x0"])
    ys = tm.mlp_rk4_fwd_plain(w, x0, _dts(data))
    wbar, lbar = tm.mlp_rk4_bwd_plain(w, ys, torch.tensor(case["g"]),
                                      _dts(data))
    want = [leaf for layer in case["wbar"] for leaf in (layer["w"],
                                                        layer["b"])]
    for got, ref in zip(wbar, want):
        assert got.shape == ref.shape
        assert max_rel(got, ref) <= 1e-5
    assert max_rel(lbar.sum(dim=0), case["x0bar"]) <= 1e-5


@pytest.mark.parametrize("H", [8, 20])
def test_plain_backward_is_the_gradient_of_the_plain_forward_f64(H, data):
    w = _w(_layers(H, C=16, seed=1), torch.float64)
    x0 = torch.tensor(data["x0"], dtype=torch.float64)
    dts = _dts(data, torch.float64)
    ys = tm.mlp_rk4_fwd_plain(w, x0, dts)
    g = torch.tensor(np.random.RandomState(6).randn(*ys.shape))
    wbar, lbar = tm.mlp_rk4_bwd_plain(w, ys, g, dts)
    wr = [x.clone().requires_grad_(True) for x in w]
    xr = x0.clone().requires_grad_(True)
    grads = torch.autograd.grad(
        (tm.mlp_rk4_fwd_plain(wr, xr, dts) * g).sum(), wr + [xr])
    for got, ref in zip(list(wbar) + [lbar.sum(dim=0)], grads):
        assert max_rel(got, ref) <= 1e-10


def test_trajectory_autograd_function_on_the_cpu(data):
    params = [{k: v.requires_grad_(True) for k, v in layer.items()}
              for layer in tmlp.params_from_numpy(_layers(8, C=8),
                                                  dtype=torch.float32)]
    x0 = torch.tensor(data["x0"]).requires_grad_(True)
    ys = tm.mlp_rk4_trajectory(params, x0, torch.tensor(data["t"]))
    g = torch.tensor(np.random.RandomState(7).randn(*ys.shape),
                     dtype=torch.float32)
    (ys * g).sum().backward()
    w = tm._flat([{k: v.detach() for k, v in layer.items()}
                  for layer in params])
    wbar, lbar = tm.mlp_rk4_bwd_plain(w, ys.detach(), g, _dts(data))
    got = [layer[k].grad for layer in params for k in ("w", "b")]
    for a, b in zip(got, wbar):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(x0.grad, lbar.sum(dim=0), rtol=0, atol=0)


def test_fused_potential_matches_jax(case):
    data = case["data"]
    jpot = jmake_potential(jnp.asarray(data["x0"]), jnp.asarray(data["t"]),
                           jnp.asarray(data["Y"]), reg=0.5, tile=128,
                           interpret=True)
    jparams = jax.tree.map(jnp.asarray, case["layers"])
    jval, vjp = jax.vjp(jpot, jparams)
    (jgrad,) = vjp(jnp.ones_like(jval))

    tpot = tm.make_fused_mlp_potential(torch.tensor(data["x0"]),
                                       torch.tensor(data["t"]),
                                       torch.tensor(data["Y"]), reg=0.5)
    params = [{k: v.requires_grad_(True) for k, v in layer.items()}
              for layer in tmlp.params_from_numpy(case["layers"],
                                                  dtype=torch.float32)]
    tval = tpot(params)
    tval.sum().backward()
    assert tval.shape == (C,) and tval.dtype == torch.float32
    np.testing.assert_allclose(to_np(tval), np.asarray(jval), rtol=1e-5)
    for layer, jlayer in zip(params, jgrad):
        for k in ("w", "b"):
            assert max_rel(layer[k].grad, jlayer[k]) <= 1e-5, k


def test_mlp_model_matches_jax_f64(data):
    """init_mlp's layout, the generic field and the generic potential
    under the fixed-grid rk4 odeint, with the JAX weights carried over."""
    gen = torch.Generator().manual_seed(0)
    p0 = tmlp.init_mlp(gen, [2, 8, 8, 2])
    assert [tuple(layer["w"].shape) for layer in p0] == [(2, 8), (8, 8),
                                                         (8, 2)]
    assert all(float(layer["w"].abs().max()) <= 0.5
               and not layer["b"].any() for layer in p0)
    jp = jmlp.init_mlp(jax.random.PRNGKey(3), [2, 8, 8, 2])
    jp = jax.tree.map(lambda x: x.astype(jnp.float64) + 0.01, jp)
    tp = tmlp.params_from_numpy(jax.tree.map(np.asarray, jp))
    x = np.random.RandomState(2).randn(7, 2)
    np.testing.assert_allclose(
        to_np(tmlp.mlp_vector_field(tp, 0.0, torch.tensor(x))),
        np.asarray(jmlp.mlp_vector_field(jp, 0.0, jnp.asarray(x))),
        rtol=1e-12, atol=1e-14)
    x0 = data["x0"].astype(np.float64)
    t = data["t"].astype(np.float64)
    X = data["Y"].astype(np.float64)
    jpot = jmlp.make_potential(
        jnp.asarray(x0), jnp.asarray(t), jnp.asarray(X),
        lambda f, y0, tt: jodeint(f, y0, tt, method="rk4"), reg=0.5,
        horizon=6)
    tpot = tmlp.make_potential(
        torch.tensor(x0), torch.tensor(t), torch.tensor(X),
        lambda f, y0, tt: todeint(f, y0, tt, method="rk4"), reg=0.5,
        horizon=6)
    np.testing.assert_allclose(float(tpot(tp)), float(jpot(jp)),
                               rtol=1e-12)
    for itr in (0, 4, 5, 100):
        assert tmlp.curriculum_length(itr, 12) == int(
            jmlp.curriculum_length(itr, 12))


def test_driver_runs_nn_at_rk4_past_one_warp(tmp_path):
    """run_sampler(model="nn", hidden=40, engine="fused", solver="rk4")
    under pSGLD on the CPU: H = 40 is past one warp of the card's kernels
    (two hidden units a lane there); the MLP's layer list in chain.npz, the
    diagnostics from the last leaf (b3), as the JAX driver's."""
    d = _wide_data(3)
    data = {"x0": d["x0"], "t": d["t"], "Y": d["Y"], "noise": 0.1}
    cfg = {"method": "pSGLD", "inf_type": "sampler", "id": 1,
           "burn_in": 1, "num_samples": 3, "thinning": 1, "num_chains": 100,
           "lr0": 1e-4, "lr_gamma": 0.55, "lr_t0": 100, "lr_alpha": 1.0,
           "psgld_alpha": 0.99, "lambda_": 1e-8, "engine": "fused",
           "solver": "rk4", "model": "nn", "hidden": 40, "seed": 0}
    summary = run_sampler(cfg, data, str(tmp_path), make_plots=False,
                          device="cpu")
    assert summary["num_chains"] == 128 and summary["kept_samples"] == 3
    assert np.isfinite(summary["min_potential"])
    # leaves of each layer in sorted key order: b, w
    chain = np.load(tmp_path / "pSGLD" / "1" / "chain.npz")
    assert chain["leaf_3"].shape == (128, 3, 40, 40)
    assert np.isfinite(np.load(tmp_path / "pSGLD" / "1"
                               / "total_loss_arr.npy")).all()
