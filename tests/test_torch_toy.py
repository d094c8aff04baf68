"""The port's toy densities, Bayesian linear regression and toy-density
experiment (`experiments.toy`), with the utilities they use (the pytree
helpers, the running-average meter, the profiling helpers), against the
JAX package's, on the CPU.

Gates.  The five toy potentials and their gradients at random points, the
linear-regression potential and its closed-form posterior: within 1e-12
of the JAX package's (relative).  `run_toy` on the banana and the
Gaussian at the JAX test's sizes (MALA at lr 1e-2, 8 chains, 50 burn-in
steps, 200 kept; tests/test_experiments.py::test_run_toy): the summary's
keys equal the JAX package's, and its means, weighted means and
acceptance agree with the JAX run's within 5 standard errors of their
difference (the random streams differ): sqrt(2) times the port run's own
standard error, from each coordinate's ESS over the recorded chains
(acceptance: the binomial one).  The pytree helpers within 1e-15,
safe_sqrt's slope at 0 is 0.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.experiments.toy import run_toy as jrun_toy
from bayesian_ode_tpu.experiments.toy import (
    weighted_posterior_mean as jweighted,
)
from bayesian_ode_tpu.models import linear_regression as jlr
from bayesian_ode_tpu.models.toy_densities import TOY_POTENTIALS as JTOY
from bayesian_ode_tpu.utils import pytree as jpt
from bayesian_ode_tpu_torch import samplers as tsamplers
from bayesian_ode_tpu_torch.experiments import toy as ttoy
from bayesian_ode_tpu_torch.experiments.run import main as cli_main
from bayesian_ode_tpu_torch.models import TOY_POTENTIALS
from bayesian_ode_tpu_torch.models import linear_regression as tlr
from bayesian_ode_tpu_torch.utils import pytree as tpt
from bayesian_ode_tpu_torch.utils.meters import RunningAverageMeter
from bayesian_ode_tpu_torch.utils.profiling import (
    device_timer,
    time_compiled,
    torch_trace,
)
from torch_parity import max_rel, one_torch_thread  # noqa: F401

F64 = torch.float64
TOY_CONFIG = {"method": "MALA", "lr": 1e-2, "burn_in": 50,
              "num_samples": 200, "num_chains": 8, "id": 0}


@pytest.mark.parametrize("name", sorted(JTOY))
def test_toy_potentials_and_gradients_match_jax(name):
    pts = 2.0 * np.random.RandomState(3).randn(6, 2)
    jpot, tpot = JTOY[name](), TOY_POTENTIALS[name]()
    value_and_grad = jax.jit(jax.value_and_grad(jpot))
    for p in pts:
        want, gwant = value_and_grad(jnp.asarray(p))
        x = torch.tensor(p, requires_grad=True)
        got = tpot(x)
        g, = torch.autograd.grad(got, x)
        assert abs(float(got) - float(want)) <= 1e-12 * max(abs(float(want)),
                                                            1.0)
        assert max_rel(g, gwant) <= 1e-12
    # the port's potentials also take a batch of points
    batch = tpot(torch.tensor(pts))
    assert batch.shape == (6,)
    np.testing.assert_allclose(batch.numpy(),
                               [float(value_and_grad(jnp.asarray(p))[0])
                                for p in pts],
                               rtol=1e-12)


def test_linear_regression_matches_jax():
    x, y = jlr.make_data(jax.random.PRNGKey(0), n=60)
    xt, yt = torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y))
    want = jlr.exact_posterior(x, y)
    got = tlr.exact_posterior(xt, yt)
    for k in ("mean", "cov"):
        assert max_rel(got[k], want[k]) <= 1e-12
    jpot, tpot = jlr.make_potential(x, y), tlr.make_potential(xt, yt)
    for th in ([2.0, -0.7], [0.3, 1.1]):
        want, gwant = jax.value_and_grad(jpot)(jnp.asarray(th))
        t = torch.tensor(th, dtype=F64, requires_grad=True)
        u = tpot(t)
        g, = torch.autograd.grad(u, t)
        assert abs(float(u) - float(want)) <= 1e-12 * abs(float(want))
        assert max_rel(g, gwant) <= 1e-12
    # the port's generator data: its least-squares fit near (2, -0.7)
    xg, yg = tlr.make_data(torch.Generator().manual_seed(0), n=400,
                           dtype=F64)
    assert xg.shape == yg.shape == (400,)
    assert float(xg.min()) >= -2.0 and float(xg.max()) <= 2.0
    post = tlr.exact_posterior(xg, yg)
    assert abs(float(post["mean"][0]) - 2.0) < 0.1
    assert abs(float(post["mean"][1]) + 0.7) < 0.1


@pytest.fixture(scope="module")
def jax_toy(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_toy")
    return jrun_toy(TOY_CONFIG, str(out), dists=("banana", "gauss"),
                    make_plots=False)


def test_run_toy_matches_jax_moments(jax_toy, tmp_path, monkeypatch):
    recorded = []
    sample_chains = tsamplers.sample_chains

    def recording(*a, **k):
        out = sample_chains(*a, **k)
        recorded.append(out)
        return out

    monkeypatch.setattr(tsamplers, "sample_chains", recording)
    res = ttoy.run_toy(TOY_CONFIG, str(tmp_path), dists=("banana", "gauss"),
                       make_plots=True, device="cpu", dtype=F64)
    assert (tmp_path / "MALA" / "0_densities.pdf").exists()
    assert (tmp_path / "MALA" / "0.json").exists()
    assert list(res) == list(jax_toy)
    for (name, got), (_, pos, infos) in zip(res.items(), recorded):
        want = jax_toy[name]
        assert sorted(got) == sorted(want)
        assert 0.0 < got["acceptance"] <= 1.0
        n = pos.shape[0] * pos.shape[1]
        se_acc = np.sqrt(want["acceptance"] * (1 - want["acceptance"]) / n)
        assert abs(got["acceptance"] - want["acceptance"]) \
            <= 5 * np.sqrt(2) * max(se_acc, 1.0 / n)
        for d in range(2):
            chains = pos[:, :, d]
            se = float(chains.std()) / np.sqrt(float(tsamplers.ess(chains)))
            for key in ("mean", "weighted_mean"):
                diff = abs(got[key][d] - want[key][d])
                assert diff <= 5 * np.sqrt(2) * se, (name, key, d, diff, se)
    # the Gaussian target's mean is (2, 4), as the JAX test holds it
    assert abs(res["gauss"]["mean"][0] - 2.0) < 0.5
    assert abs(res["gauss"]["mean"][1] - 4.0) < 0.7


@pytest.mark.parametrize("method", ["SGLD", "pSGLD", "aSGHMC", "PT"])
def test_run_toy_samplers(method, tmp_path):
    cfg = {"method": method, "lr": 5e-2, "lr0": 5e-2, "lr_gamma": 0.55,
           "lr_t0": 100, "burn_in": 10, "num_samples": 30, "num_chains": 2,
           "num_replicas": 3, "id": 4}
    res = ttoy.run_toy(cfg, str(tmp_path), dists=("multimodal",),
                       make_plots=False, device="cpu", dtype=F64)
    r = res["multimodal"]
    assert np.all(np.isfinite(r["mean"] + r["weighted_mean"]))
    assert 0.0 < r["acceptance"] <= 1.0
    lines = (tmp_path / method / "run.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["dist"] == "multimodal"


def test_run_toy_errors_and_weighted_mean(tmp_path):
    with pytest.raises(ValueError, match="unknown toy sampler"):
        ttoy.make_toy_sampler({"method": "NUTS"}, TOY_POTENTIALS["banana"]())
    with pytest.raises(ValueError, match="unknown toy density"):
        ttoy.run_toy(TOY_CONFIG, str(tmp_path), dists=("donut",),
                     device="cpu")
    rng = np.random.RandomState(5)
    pos, steps = rng.randn(3, 7, 2), rng.rand(3, 7)
    np.testing.assert_allclose(
        ttoy.weighted_posterior_mean(torch.tensor(pos),
                                     torch.tensor(steps)).numpy(),
        np.asarray(jweighted(jnp.asarray(pos), jnp.asarray(steps))),
        rtol=1e-12)


def test_cli_runs_the_toy_experiment(tmp_path, capsys):
    blob = {"output": str(tmp_path / "out"), "data": {},
            "configs": [dict(TOY_CONFIG, burn_in=5, num_samples=10,
                             num_chains=2)]}
    (tmp_path / "1.json").write_text(json.dumps(blob))
    cli_main(["--json-dir", str(tmp_path), "--id", "1", "--experiment", "toy",
              "--no-plots", "--device", "cpu"])
    assert "'banana'" in capsys.readouterr().out
    assert (tmp_path / "out" / "MALA" / "run.jsonl").exists()


def test_pytree_helpers_match_jax():
    rng = np.random.RandomState(2)
    a = {"w": rng.randn(3, 2), "b": [rng.randn(4), np.array(rng.randn())]}
    b = {"w": rng.randn(3, 2), "b": [rng.randn(4), np.array(rng.randn())]}
    ja, jb = jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b)
    ta, tb = (tpt.tree_map(torch.tensor, t) for t in (a, b))
    pairs = [(tpt.tree_add(ta, tb), jpt.tree_add(ja, jb)),
             (tpt.tree_sub(ta, tb), jpt.tree_sub(ja, jb)),
             (tpt.tree_scale(0.3, ta), jpt.tree_scale(0.3, ja)),
             (tpt.tree_axpy(-1.7, ta, tb), jpt.tree_axpy(-1.7, ja, jb)),
             (tpt.tree_where(torch.tensor(False), ta, tb),
              jpt.tree_where(False, ja, jb)),
             (tpt.tree_stack_scalar_weighted([0.2, 0.5], [ta, tb]),
              jpt.tree_stack_scalar_weighted([0.2, 0.5], [ja, jb]))]
    for got, want in pairs:
        for g, w in zip(tpt.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15)
    assert tpt.tree_size(ta) == jpt.tree_size(ja) == 11
    np.testing.assert_allclose(float(tpt.tree_sum_squares(ta)),
                               float(jpt.tree_sum_squares(ja)), rtol=1e-15)
    np.testing.assert_allclose(float(tpt.tree_rms_norm(ta)),
                               float(jpt.tree_rms_norm(ja)), rtol=1e-15)
    # safe_sqrt: the value, and a slope of 0 (not inf or nan) at 0
    x = torch.tensor([0.0, 4.0], dtype=F64, requires_grad=True)
    g, = torch.autograd.grad(tpt.safe_sqrt(x).sum(), x)
    assert g.tolist() == [0.0, 0.25]
    assert tpt.safe_sqrt(x).tolist() == [0.0, 2.0]


def test_meter_and_profiling(tmp_path):
    m = RunningAverageMeter(momentum=0.5)
    m.update(2.0)
    assert m.avg == 2.0
    m.update(4.0)
    assert abs(m.avg - 3.0) < 1e-12
    m.reset()
    assert m.val is None and m.avg == 0.0
    x = torch.ones((64, 64))
    with device_timer("t", device="cpu", echo=False) as r:
        x @ x
    assert r["seconds"] > 0
    first, steady = time_compiled(lambda a: a @ a, x, iters=3)
    assert first > 0 and steady >= 0
    with torch_trace(str(tmp_path / "trace")) as prof:
        x @ x
    assert (tmp_path / "trace" / "trace.json").exists()
    assert len(prof.key_averages()) > 0
