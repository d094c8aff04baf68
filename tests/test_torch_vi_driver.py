"""The driver's SMC branch (`run_sampler` with method="SMC") and `run_vi`
(ADVI, Laplace) against the JAX driver in float64 on the CPU on a tiny GP
posterior (3 trajectories, T = 8, a 3x3 grid, rk4), with their artifacts;
`worker`'s "vi" and "evidence" routes and their refusals.
`test_torch_evidence_driver.py` holds `run_evidence`.

Draws are fixed by shape in both packages (`fixed_draws.py`): the JAX
SMC's per-particle move draws become the population's
(`patch_jax_smc_rows`).  Gates: every number of the summaries and the
saved arrays to 1e-8 relative (NaN where the JAX driver has NaN).
"""
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
CFG = dict(GENERIC_CONFIG, M=3)


@pytest.fixture(scope="module")
def data():
    return generic_data()


@pytest.fixture
def fixed(monkeypatch):
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch)
    fixed_draws.patch_jax_smc_rows(monkeypatch)


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


def test_smc_branch_matches_the_jax_driver(data, tmp_path, fixed):
    cfg = dict(CFG, method="SMC", num_chains=16, smc_moves=2,
               smc_max_stages=6)
    got = vg.run_sampler(cfg, data, str(tmp_path / "port"), make_plots=False,
                         device="cpu", dtype=F64)
    want = jvg.run_sampler(cfg, data, str(tmp_path / "jax"),
                           make_plots=False)
    _same_summary(got, want)
    assert got["kept_samples"] == 1 and np.isnan(got["ess_logsn"]).all()
    assert np.isfinite(got["log_z_smc"])
    port, jax_out = (tmp_path / r / "SMC" / "1" for r in ("port", "jax"))
    _same_npz(port / "chain.npz", jax_out / "chain.npz")
    _close(np.load(port / "total_loss_arr.npy"),
           np.load(jax_out / "total_loss_arr.npy"))
    assert np.load(port / "chain.npz")["leaf_0"].shape == (16, 1, 9, 2)
    for pkg, kw in ((vg.run_sampler, dict(device="cpu")),
                    (jvg.run_sampler, {})):
        with pytest.raises(ValueError, match="GP model"):
            pkg(dict(cfg, model="nn"), data, str(tmp_path / "nn"),
                make_plots=False, **kw)


@pytest.mark.parametrize("method,extra", [
    ("ADVI", dict(num_iters=8, lr=1e-2, elbo_samples=4)),
    ("ADVI", dict(num_iters=6, lr=1e-2, elbo_samples=3,
                  vi_family="fullrank", stl=True)),
    ("Laplace", dict(num_iters=4, lr=1.0))])
def test_run_vi_matches_the_jax_driver(method, extra, data, tmp_path, fixed):
    cfg = dict(CFG, method=method, inf_type="vi", num_samples=8, **extra)
    got = vg.run_vi(cfg, data, str(tmp_path / "port"), make_plots=False,
                    device="cpu", dtype=F64)
    want = jvg.run_vi(cfg, data, str(tmp_path / "jax"), make_plots=False)
    _same_summary(got, want)
    port, jax_out = (tmp_path / r / method / "1" for r in ("port", "jax"))
    for name in ("chain.npz", "variational.npz"):
        _same_npz(port / name, jax_out / name)
    names = ["total_loss_arr.npy"] + (["elbo_arr.npy"] if method == "ADVI"
                                      else [])
    for name in names:
        _close(np.load(port / name), np.load(jax_out / name))
    assert np.load(port / "chain.npz")["leaf_0"].shape[:2] == (8, 1)


def test_run_vi_routes_and_refusals(data, tmp_path, monkeypatch):
    cfg = dict(CFG, method="ADVI", inf_type="vi", num_iters=3,
               elbo_samples=2, num_samples=4)
    got = vg.worker(cfg, data, str(tmp_path), make_plots=False,
                    device="cpu")
    assert np.isfinite(got["final_elbo"]) and got["num_draws"] == 4
    with pytest.raises(ValueError, match="ADVI"):
        vg.run_vi(dict(cfg, method="SGLD"), data, str(tmp_path),
                  make_plots=False, device="cpu")

    def no_solve(*a, **k):
        raise AssertionError("built a potential")

    monkeypatch.setattr(vg, "make_generic_potential", no_solve)
    monkeypatch.setattr(vg, "make_gp_log_density_parts", no_solve)
    for route in (dict(method="Laplace", inf_type="vi"),
                  dict(method="Evidence", inf_type="evidence")):
        with pytest.raises(ValueError, match="fixed-grid solver"):
            vg.worker(dict(cfg, solver="dopri5", **route), data,
                      str(tmp_path), make_plots=False, device="cpu")
