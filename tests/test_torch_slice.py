"""The port's main-path slice as a whole, against the JAX package: the fused
GP potential of the experiment driver, the dopri5 `odeint` behind the
dataset, the experiment driver end to end, its CLI, and what importing the
port pulls in.

Gates.  Potential values to 1e-4 relative and gradients to 1e-3 max-rel:
the JAX package's gates for its own fused potential against the generic
float32 path (tests/test_pallas_ops.py), since both sides are float32
solves at rtol=1e-7 whose step meshes differ by rounding.  `odeint` in
float64 to 1e-10 relative: the same algorithm, measured 3e-14 apart.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.experiments.vanderpol_gp import run_sampler as jrun
from bayesian_ode_tpu.models import make_dataset as jmake_dataset
from bayesian_ode_tpu.models.dynamics import DYNAMICS as JDYNAMICS
from bayesian_ode_tpu.ode.odeint import odeint_with_stats as jodeint_stats
from bayesian_ode_tpu.ops.gp_dopri5_grad import (
    make_fused_gp_potential_dopri5 as jmake_potential,
)
from bayesian_ode_tpu_torch import odeint_with_stats as todeint_stats
from bayesian_ode_tpu_torch.experiments import run_sampler
from bayesian_ode_tpu_torch.models.dynamics import DYNAMICS as TDYNAMICS
from bayesian_ode_tpu_torch.ops import fused_adaptive as fa
from bayesian_ode_tpu_torch.ops.gp_dopri5_grad import (
    make_fused_gp_potential_dopri5,
)
from torch_parity import gp_problem, max_rel, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the experiment driver's config of the main path at a small size
SGLD_CONFIG = {
    "method": "SGLD", "inf_type": "sampler", "id": 1, "M": 6, "sf": 1.0,
    "ell": 0.75, "noise": 0.05, "burn_in": 1, "num_samples": 4,
    "thinning": 1, "num_chains": 100, "lr0": 1e-5, "lr_gamma": 0.55,
    "lr_t0": 100, "lr_alpha": 1.0, "psgld_alpha": 0.99, "lambda_": 1e-8,
    "engine": "fused", "solver": "dopri5", "model": "gp", "seed": 0,
}


@pytest.fixture(scope="module")
def problem():
    return gp_problem()


def test_fused_potential_matches_jax(problem):
    p = problem
    Y = p["Y"]
    jpot = jmake_potential(p["jstatic32"], jnp.asarray(p["x0"]),
                           jnp.asarray(p["t"]), jnp.asarray(Y),
                           store_steps=128, tile=128, interpret=True)
    jparams = {"U": jnp.asarray(p["U"]), "logsn": jnp.asarray(p["logsn"])}
    jval = jpot(jparams)
    jgrad = jax.grad(lambda q: jnp.sum(jpot(q)))(jparams)

    tpot = make_fused_gp_potential_dopri5(
        p["tstatic"], torch.tensor(p["x0"]), torch.tensor(p["t"]),
        torch.tensor(Y), store_steps=128)
    tparams = {k: torch.tensor(p[k]).requires_grad_(True)
               for k in ("U", "logsn")}
    tval = tpot(tparams)
    tval.sum().backward()

    assert tval.shape == (p["U"].shape[0],) and tval.dtype == torch.float32
    np.testing.assert_allclose(to_np(tval), np.asarray(jval), rtol=1e-4)
    for k in ("U", "logsn"):
        assert max_rel(tparams[k].grad, jgrad[k]) <= 1e-3, k


@pytest.mark.parametrize("rtol,atol", [(1e-7, 1e-9), (1e-5, 1e-7)])
def test_odeint_dopri5_matches_jax_f64(rtol, atol):
    x0 = 1.5 * np.random.RandomState(0).randn(5, 2)
    t = np.linspace(0.0, 6.0, 60)
    yj, sj = jodeint_stats(JDYNAMICS["vdp"], jnp.asarray(x0), jnp.asarray(t),
                           rtol, atol, method="dopri5")
    yt, st = todeint_stats(TDYNAMICS["vdp"], torch.tensor(x0),
                           torch.tensor(t), rtol, atol, method="dopri5")
    assert yt.dtype == torch.float64 and yt.shape == yj.shape
    yj = np.asarray(yj)
    assert np.max(np.abs(to_np(yt) - yj)) <= 1e-10 * np.max(np.abs(yj))
    for key in ("nfe", "n_accepted", "n_rejected"):
        assert int(st[key]) == int(sj[key]), key
    assert bool(st["reached_final_time"])


def test_odeint_batched_systems_match_one_by_one():
    x0 = torch.tensor(1.5 * np.random.RandomState(1).randn(3, 5, 2))
    t = torch.linspace(0.0, 2.5, 12, dtype=torch.float64)
    f = TDYNAMICS["vdp"]
    ys, st = todeint_stats(lambda tt, y: f(tt, y), x0, t, batched=True)
    for b in range(3):
        yb, sb = todeint_stats(f, x0[b], t)
        torch.testing.assert_close(ys[:, b], yb, rtol=0, atol=0)
        assert int(st["nfe"][b]) == int(sb["nfe"])


def _jax_summary_keys(tmp_path):
    """The summary keys of the JAX experiment driver, from a cheap run (the
    generic engine with Euler steps: the keys do not depend on either)."""
    data = jmake_dataset(jax.random.PRNGKey(2), "vdp", N=5, T=12, t_max=2.5,
                         noise=0.05, x0_scale=1.5)
    cfg = dict(SGLD_CONFIG, engine="generic", solver="euler", num_chains=2)
    return set(jrun(cfg, data, str(tmp_path / "jax"), make_plots=False))


def test_run_sampler_end_to_end(problem, tmp_path):
    p = problem
    data = {"x0": p["x0"], "t": p["t"], "Y": p["Y"], "noise": 0.05}
    cfg = dict(SGLD_CONFIG, burn_in=1, num_samples=2)
    summary = run_sampler(cfg, data, str(tmp_path / "port"),
                          make_plots=False)
    assert set(summary) == _jax_summary_keys(tmp_path)
    assert summary["num_chains"] == 128          # rounded up to 128
    assert summary["kept_samples"] == 2
    for key in ("min_potential", "median_potential", "acceptance"):
        assert np.isfinite(summary[key]), key
    out = tmp_path / "port" / "SGLD" / "1"
    pots = np.load(out / "total_loss_arr.npy")
    assert pots.shape == (128, 2) and np.isfinite(pots).all()
    # leaves in sorted key order, as the JAX package's save_pytree
    chain = np.load(out / "chain.npz")
    assert list(chain["__keys__"]) == ["U", "logsn"]
    assert chain["leaf_0"].shape == (128, 2, 36, 2)
    assert chain["leaf_1"].shape == (128, 2, 2)
    assert np.isfinite(chain["leaf_0"]).all()
    logged = json.loads((out / "run.jsonl").read_text().splitlines()[-1])
    assert logged["event"] == "summary"


def test_run_sampler_psgld_and_unported_options(problem, tmp_path):
    p = problem
    data = {"x0": p["x0"], "t": p["t"], "Y": p["Y"], "noise": 0.05}
    cfg = dict(SGLD_CONFIG, method="pSGLD", burn_in=0, num_samples=1)
    summary = run_sampler(cfg, data, str(tmp_path), make_plots=False)
    assert np.isfinite(summary["min_potential"])
    for bad in ({"engine": "generic"}, {"solver": "rk4"},
                {"method": "MALA"}, {"model": "nn"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_sampler(dict(cfg, **bad), data, str(tmp_path),
                        make_plots=False)
    with pytest.raises(NotImplementedError, match="plots"):
        run_sampler(cfg, data, str(tmp_path), make_plots=True)


def test_cli_runs_the_experiment_driver(tmp_path):
    blob = {"output": str(tmp_path / "out"),
            "data": {"ode": "vdp", "N": 5, "T": 12, "t_max": 2.5,
                     "noise": 0.05, "x0_scale": 1.5, "seed": 0},
            "configs": [dict(SGLD_CONFIG, num_samples=1, burn_in=0)]}
    (tmp_path / "1.json").write_text(json.dumps(blob))
    proc = subprocess.run(
        [sys.executable, "-m", "bayesian_ode_tpu_torch.experiments.run",
         "--json-dir", str(tmp_path), "--id", "1", "--no-plots",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "'event': 'summary'" in proc.stdout
    assert (tmp_path / "out" / "SGLD" / "1" / "chain.npz").exists()


def test_importing_the_port_needs_no_jax_triton_or_nvcc(tmp_path):
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import bayesian_ode_tpu_torch as pkg
        for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(mod.name)
        from bayesian_ode_tpu_torch.ops import _build
        bad = [m for m in ("jax", "jaxlib", "triton") if m in sys.modules]
        assert not bad, bad
        assert not _build._LIBS
        print("ok")
    """)
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=dict(env, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_kernel_wrappers_take_the_plain_path_only_on_the_cpu(problem):
    """A tensor on any device but the CPU reaches a kernel or an error,
    never the plain version (the meta device stands in for one here)."""
    A = torch.empty((8, 36, 2), device="meta")
    Z = torch.empty((36, 2), device="meta")
    ts = torch.empty((12,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.fwd(A, Z, torch.empty((8, 5, 2), device="meta"),
               torch.empty((8, 5, 2), device="meta"),
               torch.empty((8,), device="meta"), ts, 1.0, 0.75, 1e-7, 1e-9,
               0.9, 10.0, 0.2, 100, "i", record=True)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.bwd(A, Z, ts, torch.empty((128, 12, 8), device="meta"),
               torch.empty((8,), dtype=torch.int32, device="meta"),
               torch.empty((12, 8, 5, 2), device="meta"), 1.0, 0.75)
