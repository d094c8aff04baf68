"""`run_evidence` through `worker` (TI and stepping stone, two SMC runs,
generalized stepping stone, Laplace in float64, WAIC and PSIS-LOO, the
reliability flags) against the JAX driver in float64 on the CPU on a tiny
GP posterior (3 trajectories, T = 8, a 3x3 grid, rk4), with its
artifacts.  `test_torch_vi_driver.py` holds the SMC branch and `run_vi`.

Draws are fixed by shape in both packages (`fixed_draws.py`): the JAX
SMC's per-particle move draws become the population's
(`patch_jax_smc_rows`), and the port's float32 exp of the ladder's log
steps goes through XLA's (see test_torch_evidence.py).  Gates: every
number of the summaries, evidence.json and the saved arrays to 1e-8
relative (NaN where the JAX driver has NaN), the flags and rank_by equal.
"""
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixed_draws
from bayesian_ode_tpu.experiments import vanderpol_gp as jvg
from bayesian_ode_tpu_torch.experiments import vanderpol_gp as vg
from torch_parity import (  # noqa: F401
    GENERIC_CONFIG,
    generic_data,
    one_torch_thread,
)

F64 = torch.float64
tev = importlib.import_module("bayesian_ode_tpu_torch.samplers.evidence")
CFG = dict(GENERIC_CONFIG, M=3)


@pytest.fixture(scope="module")
def data():
    return generic_data()


@pytest.fixture
def fixed(monkeypatch):
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch)
    fixed_draws.patch_jax_smc_rows(monkeypatch)
    monkeypatch.setattr(tev, "_step_of", lambda x: torch.tensor(
        np.asarray(jnp.exp(jnp.asarray(x.numpy())))))


def _close(a, b, rtol=1e-8):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=1e-12, equal_nan=True)


def _same_summary(got, want, rtol=1e-8):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, float):
            _close(got[k], w, rtol)
        elif isinstance(w, list) and w and isinstance(w[0], float):
            _close(got[k], w, rtol)
        else:
            assert got[k] == w, k


def _same_npz(a, b, rtol=1e-8):
    a, b = np.load(a), np.load(b)
    leaves = sorted(k for k in b.files if k.startswith("leaf_"))
    assert sorted(k for k in a.files if k.startswith("leaf_")) == leaves
    assert str(a["__treedef__"]) == str(b["__treedef__"])
    for k in leaves:
        _close(a[k], b[k], rtol)


EVIDENCE = dict(CFG, method="Evidence", inf_type="evidence", num_rungs=3,
                num_chains=4, lr=1e-3, burn_in=4, num_samples=6,
                thinning=1, jitter=0.05, smc_particles=32, smc_repeats=2,
                smc_moves=2, smc_max_stages=5, laplace_iters=5)


def test_run_evidence_through_worker_matches_the_jax_driver(data, tmp_path,
                                                           fixed,
                                                           monkeypatch):
    # the JAX predictive scores jitted (eagerly they take 10 s here)
    for name in ("waic", "psis_loo"):
        monkeypatch.setattr(jvg.samplers, name,
                            jax.jit(getattr(jvg.samplers, name)))
    got = vg.worker(EVIDENCE, data, str(tmp_path / "port"),
                    make_plots=False, device="cpu", dtype=F64)
    want = jvg.worker(EVIDENCE, data, str(tmp_path / "jax"),
                      make_plots=False)
    _same_summary(got, want)
    assert got["rank_by"] and np.isfinite(got["log_z_smc"])
    port, jax_out = (tmp_path / r / "Evidence" / "1" for r in ("port",
                                                              "jax"))
    detail = json.loads((port / "evidence.json").read_text())
    _same_summary(detail, json.loads((jax_out / "evidence.json").read_text()))
    _same_npz(port / "chain.npz", jax_out / "chain.npz")
    logged = json.loads((port / "run.jsonl").read_text().splitlines()[-1])
    assert logged["event"] == "summary" and logged["rank_by"] == \
        got["rank_by"]
    assert json.loads((port / "config.json").read_text())["num_rungs"] == 3
