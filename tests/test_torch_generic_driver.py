"""The generic engine through the port's driver (`run_sampler` with
engine="generic", and method="SVGD") against the JAX driver, in float64
on the CPU.

Both drivers start every chain at the model's start point (jitter 0) and
draw no noise: the Langevin noise is zeroed in both packages' samplers,
and MALA's uniform is 0 in both, so every finite proposal is accepted.
The steps are then deterministic, and the summary keys, the per-step
potentials and the saved chains are held to the JAX driver's.  SVGD from
one point is the mean-score flow.  Every solver of the registry runs
(adams held to the JAX driver).  The plots: make_plots=True writes the JAX
driver's PDF files, and the numbers they draw (`sampler_plot_numbers`:
the mode's field on the 15 x 15 grid, the 64-draw rk4 predictive bands,
the dopri5 truth) are within 1e-10 of the same numbers computed by the
JAX package's functions as its `_plots_sampler` and `_plots_sampler_nn`
compute them.  The config helpers write what the JAX package's write.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.experiments.vanderpol_gp import run_sampler as jrun
from bayesian_ode_tpu.samplers import langevin as jlangevin
from bayesian_ode_tpu_torch import samplers
from bayesian_ode_tpu_torch.experiments.run import main as cli_main
from bayesian_ode_tpu_torch.experiments.vanderpol_gp import run_sampler
from bayesian_ode_tpu_torch.samplers import langevin as tlangevin
from bayesian_ode_tpu_torch.utils.pytree import tree_map
from torch_parity import (  # noqa: F401
    GENERIC_CONFIG,
    generic_data,
    one_torch_thread,
)


@pytest.fixture(scope="module")
def data():
    return generic_data()


@pytest.fixture
def no_noise(monkeypatch):
    monkeypatch.setattr(jlangevin, "tree_random_normal",
                        lambda key, a: jax.tree.map(jnp.zeros_like, a))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, *a, **k: jnp.zeros(()))
    monkeypatch.setattr(tlangevin, "tree_random_normal",
                        lambda gen, a: tree_map(torch.zeros_like, a))
    monkeypatch.setattr(tlangevin.torch, "rand",
                        lambda shape, **k: torch.zeros(shape, **{
                            n: v for n, v in k.items()
                            if n in ("dtype", "device")}))


def _run_both(cfg, data, tmp_path):
    got = run_sampler(cfg, data, str(tmp_path / "port"), make_plots=False,
                      device="cpu", dtype=torch.float64)
    want = jrun(cfg, data, str(tmp_path / "jax"), make_plots=False)
    out = lambda root: (tmp_path / root / cfg["method"]  # noqa: E731
                        / str(cfg["id"]))
    return got, want, out("port"), out("jax")


@pytest.mark.parametrize("method", ["SGLD", "pSGLD", "aSGLD", "cSGLD",
                                    "MALA", "AdamSGLD"])
def test_generic_methods_match_the_jax_driver(data, tmp_path, no_noise,
                                              method):
    cfg = dict(GENERIC_CONFIG, method=method, num_chains=3)
    if method == "cSGLD":
        cfg["lr0"] = 1e-6
    got, want, port, jax_out = _run_both(cfg, data, tmp_path)
    assert set(got) == set(want)
    assert got["num_chains"] == 3                  # not rounded to 128
    for key in ("min_potential", "median_potential", "acceptance"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9)
    np.testing.assert_allclose(np.load(port / "total_loss_arr.npy"),
                               np.load(jax_out / "total_loss_arr.npy"),
                               rtol=1e-9)
    a, b = np.load(port / "chain.npz"), np.load(jax_out / "chain.npz")
    assert str(a["__treedef__"]) == str(b["__treedef__"])
    for k in ("leaf_0", "leaf_1"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-9, atol=1e-12)


def test_generic_adams_matches_the_jax_driver(data, tmp_path, no_noise):
    """solver="adams" on the generic engine (config rtol/atol, as the JAX
    driver's adaptive solvers take them; 1e-5 / 1e-7 here): one SGLD step
    of 3 chains with
    the noise zeroed, the potentials and the chain against the JAX
    driver's.  VCABM amplifies the two packages' rounding of the field
    (test_torch_vcabm.py), so the gate is 1e-7 relative."""
    cfg = dict(GENERIC_CONFIG, method="SGLD", solver="adams", num_chains=3,
               burn_in=0, num_samples=1, rtol=1e-5, atol=1e-7)
    got, want, port, jax_out = _run_both(cfg, data, tmp_path)
    assert set(got) == set(want) and got["num_chains"] == 3
    np.testing.assert_allclose(np.load(port / "total_loss_arr.npy"),
                               np.load(jax_out / "total_loss_arr.npy"),
                               rtol=1e-7)
    a, b = np.load(port / "chain.npz"), np.load(jax_out / "chain.npz")
    for k in ("leaf_0", "leaf_1"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-7, atol=1e-12)


def test_svgd_through_the_driver_matches_jax(data, tmp_path):
    """method="SVGD" on the GP generic potential, particles from one point
    (jitter 0): phi is then the mean score at every step, in both.  The
    norm expansion leaves each package its own rounding (~1e-15 |x|^2) in
    the zero distances, which the median bandwidth of a collapsed
    ensemble (gamma = 1e8) scales to ~1e-7: the gate is 1e-6."""
    cfg = dict(GENERIC_CONFIG, method="SVGD", num_chains=4, num_samples=3,
               lr=1e-5)
    got, want, port, jax_out = _run_both(cfg, data, tmp_path)
    assert set(got) == set(want) and got["num_chains"] == 4
    np.testing.assert_allclose(np.load(port / "total_loss_arr.npy"),
                               np.load(jax_out / "total_loss_arr.npy"),
                               rtol=1e-6)
    a, b = np.load(port / "chain.npz"), np.load(jax_out / "chain.npz")
    assert str(a["__treedef__"]) == str(b["__treedef__"])
    assert a["leaf_0"].shape == b["leaf_0"].shape == (4, 3, 16, 2)
    np.testing.assert_allclose(a["leaf_0"], b["leaf_0"], rtol=1e-6,
                               atol=1e-9)


def test_svgd_lowers_the_mean_potential(data, tmp_path):
    """SVGD from a jittered ensemble on the CPU, where phi takes its
    matmul form: the ensemble's mean potential falls step by step."""
    cfg = dict(GENERIC_CONFIG, method="SVGD", num_chains=8, burn_in=0,
               num_samples=4, lr=2e-4, jitter=0.005)
    run_sampler(cfg, data, str(tmp_path), make_plots=False, device="cpu",
                dtype=torch.float64)
    pots = np.load(tmp_path / "SVGD" / "1" / "total_loss_arr.npy")[0]
    assert np.all(np.diff(pots) < 0)


def test_guard_finite_freezes_only_the_divergent_chain():
    """guard_finite_batched: a chain whose step turns non-finite keeps its
    last finite state; the others move on.  The driver's guard_finite key
    wraps the generic engine's kernel in it."""
    def pot(p):
        x = p["x"]
        return torch.where(x[:, 0] > 1.0, torch.nan, 0.5 * (x ** 2).sum(1))

    kernel = samplers.guard_finite_batched(
        samplers.sgld_batched(pot, -0.5, add_noise=False))
    state = kernel.init({"x": torch.tensor([[0.5, 0.1], [0.9, 0.2]],
                                           dtype=torch.float64)})
    new, info = kernel.step(torch.Generator(), state)
    assert info["finite"].tolist() == [True, False]
    torch.testing.assert_close(new.position["x"][1],
                               state.position["x"][1])
    assert not torch.equal(new.position["x"][0], state.position["x"][0])


def test_generic_driver_options(data, tmp_path):
    cfg = dict(GENERIC_CONFIG, guard_finite=True, num_chains=2,
               jitter=0.005)
    s = run_sampler(cfg, data, str(tmp_path), make_plots=False,
                    device="cpu", dtype=torch.float64)
    assert s["num_chains"] == 2 and np.isfinite(s["min_potential"])
    # the default engine is the generic one, as in the JAX driver
    cfg.pop("engine")
    s = run_sampler(dict(cfg, model="spiral", solver="dopri5"), data,
                    str(tmp_path), make_plots=False, device="cpu",
                    dtype=torch.float64)
    assert np.isfinite(s["min_potential"])


def test_unported_methods_solvers_and_options_raise(data, tmp_path):
    def run(**kw):
        run_sampler(dict(GENERIC_CONFIG, **kw), data, str(tmp_path),
                    make_plots=False, device="cpu", dtype=torch.float64)

    # MMALA raises the JAX driver's TypeError; SMC runs (GP model only)
    with pytest.raises(TypeError, match="custom_vjp"):
        run(method="MMALA")
    s = run_sampler(dict(GENERIC_CONFIG, method="SMC", num_chains=8,
                         smc_moves=1, smc_max_stages=2), data,
                    str(tmp_path), make_plots=False, device="cpu",
                    dtype=torch.float64)
    assert np.isfinite(s["log_z_smc"])
    with pytest.raises(ValueError, match="GP model"):
        run(method="SMC", model="spiral")
    # every registry solver passes vanderpol_gp's config checks (adams
    # runs through it in test_generic_adams_matches_the_jax_driver, the solvers
    # themselves against JAX in their own files)
    from bayesian_ode_tpu_torch.experiments import vanderpol_gp as vg

    for solver in ("adams", "bosh3", "dopri8", "sdirk4", "fixed_adams"):
        vg._check_supported(dict(GENERIC_CONFIG, solver=solver))
    # make_plots=True (the default) writes the JAX driver's files
    plots = tmp_path / "plots"
    run_sampler(GENERIC_CONFIG, data, str(plots), device="cpu")
    for name in ("post", "phase_mode", "predictive_bands", "logsn_hist"):
        assert (plots / "SGLD" / "1" / f"{name}.pdf").stat().st_size > 0
    with pytest.raises(ValueError, match="unknown sampler method"):
        run(method="Gibbs")
    with pytest.raises(ValueError, match="unknown method"):
        run(solver="rk45")


def test_cli_passes_the_engine_through(tmp_path):
    blob = {"output": str(tmp_path / "out"),
            "data": {"ode": "vdp", "N": 3, "T": 6, "t_max": 1.5,
                     "noise": 0.05, "x0_scale": 1.5, "seed": 0},
            "configs": [dict(GENERIC_CONFIG, model="spiral", num_chains=3,
                             num_samples=1)]}
    (tmp_path / "2.json").write_text(json.dumps(blob))
    cli_main(["--json-dir", str(tmp_path), "--id", "2", "--no-plots",
              "--device", "cpu"])
    out = tmp_path / "out" / "SGLD" / "1"
    assert np.load(out / "total_loss_arr.npy").shape == (3, 1)


def _jax_sampler_numbers(cfg, data, positions, pots):
    """The numbers the JAX driver's `_plots_sampler` (GP) or
    `_plots_sampler_nn` (MLP) draws, computed by its own functions."""
    from bayesian_ode_tpu import odeint as jodeint
    from bayesian_ode_tpu.experiments.vanderpol_gp import build_model as jb
    from bayesian_ode_tpu.models import DYNAMICS as JDYN
    from bayesian_ode_tpu.models import kernel_regression as jkr
    from bayesian_ode_tpu.models import mlp as jmlp

    jstatic = jb(cfg, data)[0]
    ci, si = np.unravel_index(np.argmin(pots), pots.shape)
    mode = jax.tree.map(lambda x: jnp.asarray(x[ci, si]), positions)
    lo = np.asarray(data["Y"]).reshape(-1, 2).min(0) - 0.5
    hi = np.asarray(data["Y"]).reshape(-1, 2).max(0) + 0.5
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], 15),
                         np.linspace(lo[1], hi[1], 15))
    pts = jnp.asarray(np.stack([gx.ravel(), gy.ravel()], 1))
    if jstatic is None:
        return {"field": np.asarray(jmlp.mlp_vector_field(mode, 0.0, pts))}
    out = {"field": np.asarray(jkr.vector_field(mode, jstatic, 0.0, pts))}
    rng = np.random.RandomState(0)
    x0_ = jnp.asarray(2.0 * 1.0 * rng.uniform(size=(3, 2)) - 1.0)
    t_ = jnp.linspace(0.0, 14.0, 80)
    flat_U = positions["U"].reshape(-1, *positions["U"].shape[2:])
    idx = rng.choice(flat_U.shape[0], min(64, pots.size), replace=False)

    def solve_draw(U):
        A = jstatic.KzzinvL @ U
        return jodeint(lambda tt, X: jkr.vector_field_fast(A, jstatic, tt, X),
                       x0_, t_, method="rk4")

    sols = np.asarray(jax.vmap(solve_draw)(jnp.asarray(flat_U[idx])))
    out.update(band_mean=sols.mean(0), band_std=sols.std(0),
               truth=np.asarray(jodeint(JDYN["vdp"], x0_, t_,
                                        method="dopri5")),
               band_x0=np.asarray(x0_), band_t=np.asarray(t_))
    return out


@pytest.mark.parametrize("model", ["gp", "nn"])
def test_sampler_plot_numbers_match_jax(data, model):
    from bayesian_ode_tpu.experiments.vanderpol_gp import build_model as jb
    from bayesian_ode_tpu_torch.experiments import vanderpol_gp as vg
    from bayesian_ode_tpu_torch.models import kernel_regression as tkr

    cfg = dict(GENERIC_CONFIG, model=model)
    jstatic, params0 = jb(cfg, data)[:2]
    rng = np.random.RandomState(4)
    positions = jax.tree.map(lambda x: np.asarray(x)[None, None]
                             + 0.01 * rng.randn(3, 4, *np.shape(x)),
                             params0)
    pots = rng.rand(3, 4)
    static = None if jstatic is None else tkr.static_from_numpy(
        jstatic.Z, jstatic.KzzinvL, jstatic.Kzzinv, jstatic.sf, jstatic.ell)
    got = vg.sampler_plot_numbers(
        cfg, data, static, tree_map(torch.tensor, positions), pots,
        device="cpu")
    want = _jax_sampler_numbers(cfg, data, positions, pots)
    assert set(got) == set(want) | {"grid_x", "grid_y"}
    assert got["field"].shape == (225, 2)
    for k, w in want.items():
        assert np.max(np.abs(got[k] - w)) <= 1e-10 * np.max(np.abs(w)), k


def test_config_helpers_match_jax(tmp_path):
    from bayesian_ode_tpu.experiments import config as jconfig
    from bayesian_ode_tpu_torch.experiments import config as tconfig

    assert tconfig.SENSIBLE_PARAMS == jconfig.SENSIBLE_PARAMS
    assert tconfig.DEFAULT_VALUES == jconfig.DEFAULT_VALUES
    cfg = dict(GENERIC_CONFIG, lr_decay=0.1, history_size=7)
    assert tconfig.dir_name_for(cfg) == jconfig.dir_name_for(cfg)
    grid = {"lr": [1e-3, 1e-4], "M": [4, 5], "engine": ["fused"]}
    got = tconfig.expand_grid("pSGLD", grid, defaults={"num_chains": 8})
    assert got == jconfig.expand_grid("pSGLD", grid,
                                      defaults={"num_chains": 8})
    assert len(got) == 4 and got[0]["dir_name"].startswith("_M4")
    n = tconfig.write_configs(got, str(tmp_path / "port"), "out",
                              data={"N": 3}, start_id=3)
    jconfig.write_configs(got, str(tmp_path / "jax"), "out", data={"N": 3},
                          start_id=3)
    assert n == 4
    for i in range(3, 7):
        a = (tmp_path / "port" / f"{i}.json").read_text()
        assert a == (tmp_path / "jax" / f"{i}.json").read_text()
        assert tconfig.load_config(str(tmp_path / "port"), i) == json.loads(a)
