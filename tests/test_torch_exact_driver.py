"""The exact and population samplers through the port's driver
(`run_sampler` with method HMC, AdaptiveHMC, NUTS, AdaptiveNUTS, PT or
Ensemble on the generic engine), against the JAX driver in float64 on the
CPU; checkpointed runs and their resume; the CLI's --resume.

Draws.  Both packages' draws are fixed (`fixed_draws.py`).  The JAX
driver runs HMC and NUTS per chain under vmap, where every chain draws
the same fixed values, so the port's batched kernels draw one chain's
values on every chain there (`chain_constant`); PT and Ensemble are
batched in both drivers.  The port's float32 exp of the warmup's log step
goes through XLA's (see test_torch_hmc.py).

Gates.  The kept potentials, the saved chains and the summary to 1e-9
relative, the adaptive methods' too (their warmup state is float32 in
both packages); the summary's keys equal, PT's swap_acceptance among
them.  A checkpointed run that dies at its third save and is resumed
gives the uninterrupted run's chain bit for bit.
"""
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixed_draws
from bayesian_ode_tpu.experiments.vanderpol_gp import run_sampler as jrun
from bayesian_ode_tpu_torch.experiments import vanderpol_gp as vg
from bayesian_ode_tpu_torch.experiments.run import main as cli_main
from bayesian_ode_tpu_torch.experiments.vanderpol_gp import run_sampler
from torch_parity import (  # noqa: F401
    GENERIC_CONFIG,
    generic_data,
    one_torch_thread,
)

tham = importlib.import_module("bayesian_ode_tpu_torch.samplers.hamiltonian")
tnuts = importlib.import_module("bayesian_ode_tpu_torch.samplers.nuts")
ckpt_mod = importlib.import_module("bayesian_ode_tpu_torch.utils.checkpoint")

F64 = torch.float64
PER_CHAIN = ("HMC", "AdaptiveHMC", "NUTS", "AdaptiveNUTS")
EXACT = dict(lr=2e-3, num_leapfrog=3, max_depth=3, num_replicas=3,
             beta_min=0.25, eps_jitter=0.2, burn_in=2, num_samples=3,
             jitter=0.002)


@pytest.fixture(scope="module")
def data():
    return generic_data()


def xla_exp(x):
    return torch.tensor(np.asarray(jnp.exp(jnp.asarray(x.numpy()))))


def _fix(monkeypatch, method):
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch,
                            chain_constant=method in PER_CHAIN)
    monkeypatch.setattr(tham, "_step_of", xla_exp)
    monkeypatch.setattr(tnuts, "_step_of", xla_exp)


def _compare(got, want, port, jax_out, rtol):
    assert set(got) == set(want)
    assert got["num_chains"] == want["num_chains"]
    for key in ("min_potential", "median_potential", "acceptance"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol)
    np.testing.assert_allclose(np.load(port / "total_loss_arr.npy"),
                               np.load(jax_out / "total_loss_arr.npy"),
                               rtol=rtol)
    a, b = np.load(port / "chain.npz"), np.load(jax_out / "chain.npz")
    assert str(a["__treedef__"]) == str(b["__treedef__"])
    for k in ("leaf_0", "leaf_1"):
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("method", ["HMC", "AdaptiveHMC", "NUTS",
                                    "AdaptiveNUTS", "PT", "Ensemble"])
def test_generic_driver_matches_the_jax_driver(method, data, tmp_path,
                                               monkeypatch):
    """The GP posterior on the generic engine at rk4, 4 chains (PT: 3
    rungs over them), 2 burn-in (warmup) steps then 3 kept; moves are
    accepted in every method's run."""
    _fix(monkeypatch, method)
    cfg = dict(GENERIC_CONFIG, method=method, num_chains=4, **EXACT)
    if method.startswith("Adaptive") or method == "PT":
        cfg["lr"] = 1e-4        # moves accepted: the comparison sees moves
    got = run_sampler(cfg, data, str(tmp_path / "port"), make_plots=False,
                      device="cpu", dtype=F64)
    want = jrun(cfg, data, str(tmp_path / "jax"), make_plots=False)
    out = lambda root: tmp_path / root / method / "1"  # noqa: E731
    _compare(got, want, out("port"), out("jax"), 1e-9)
    assert ("swap_acceptance" in got) == (method == "PT")
    if method == "PT":
        np.testing.assert_allclose(got["swap_acceptance"],
                                   want["swap_acceptance"], rtol=1e-12)
        assert got["swap_acceptance"] > 0
    assert got["acceptance"] > 0


def test_ensemble_rounds_to_an_even_walker_count(data, tmp_path):
    cfg = dict(GENERIC_CONFIG, method="Ensemble", num_chains=5, burn_in=0,
               num_samples=1)
    got = run_sampler(cfg, data, str(tmp_path), make_plots=False,
                      device="cpu", dtype=F64)
    assert got["num_chains"] == 6


def test_only_smc_and_mmala_stay_unported(data, tmp_path):
    """SMC and MMALA were the last methods the port's driver refused.  SMC
    now runs; MMALA raises the TypeError the JAX driver raises (its
    metric's jax.hessian, forward over reverse, cannot pass the adjoint's
    custom_vjp), before any solve."""
    assert not hasattr(vg, "UNPORTED_METHODS")
    s = run_sampler(dict(GENERIC_CONFIG, method="SMC", num_chains=8,
                         smc_moves=1, smc_max_stages=3), data,
                    str(tmp_path / "smc"), make_plots=False, device="cpu",
                    dtype=F64)
    assert s["kept_samples"] == 1 and np.isfinite(s["log_z_smc"])
    cfg = dict(GENERIC_CONFIG, method="MMALA")
    with pytest.raises(TypeError, match="forward-mode autodiff"):
        run_sampler(cfg, data, str(tmp_path), make_plots=False,
                    device="cpu")
    with pytest.raises(TypeError, match="forward-mode autodiff"):
        jrun(cfg, data, str(tmp_path / "jax"), make_plots=False)


def _chain(root, method="Ensemble"):
    return np.load(root / method / "1" / "chain.npz")


@pytest.mark.parametrize("method", ["Ensemble", "AdaptiveNUTS"])
def test_checkpoint_resume_equals_uninterrupted(method, data, tmp_path,
                                                monkeypatch):
    """The JAX package's resume gate (tests/test_experiments.py): the
    third checkpoint save dies mid-run; resumed from sampler_ckpt.npz, the
    run's chain, potentials and summary equal an uninterrupted
    checkpointed run's bit for bit (segment generators included)."""
    cfg = dict(GENERIC_CONFIG, method=method, num_chains=4, thinning=1,
               ckpt_every=2, **dict(EXACT, num_samples=7))
    a_dir = tmp_path / "a"
    want = run_sampler(dict(cfg), data, str(a_dir), make_plots=False,
                       device="cpu", dtype=F64)

    b_dir = tmp_path / "b"
    real_save = ckpt_mod.save_pytree
    calls = {"n": 0}

    def dying_save(path, tree):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise KeyboardInterrupt("simulated mid-run kill")
        real_save(path, tree)

    monkeypatch.setattr(ckpt_mod, "save_pytree", dying_save)
    with pytest.raises(KeyboardInterrupt):
        run_sampler(dict(cfg), data, str(b_dir), make_plots=False,
                    device="cpu", dtype=F64)
    monkeypatch.setattr(ckpt_mod, "save_pytree", real_save)
    ck = b_dir / method / "1" / "sampler_ckpt.npz"
    assert ck.exists()
    got = run_sampler(dict(cfg, resume=True), data, str(b_dir),
                      make_plots=False, device="cpu", dtype=F64)
    assert got == want
    chain_a, chain_b = _chain(a_dir, method), _chain(b_dir, method)
    assert sorted(chain_a.files) == sorted(chain_b.files)
    for k in chain_a.files:
        np.testing.assert_array_equal(chain_a[k], chain_b[k], err_msg=k)
    np.testing.assert_array_equal(
        np.load(a_dir / method / "1" / "total_loss_arr.npy"),
        np.load(b_dir / method / "1" / "total_loss_arr.npy"))
    assert chain_a["leaf_0"].shape[1] == 7


def test_resume_rejects_a_checkpoint_of_another_structure(data, tmp_path):
    """`load_pytree` checks the stored structure: an Ensemble checkpoint
    does not load as a PT state."""
    cfg = dict(GENERIC_CONFIG, method="Ensemble", num_chains=4,
               ckpt_every=2, burn_in=0, num_samples=2)
    run_sampler(cfg, data, str(tmp_path), make_plots=False, device="cpu",
                dtype=F64)
    path = str(tmp_path / "Ensemble" / "1" / "sampler_ckpt.npz")
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt_mod.load_pytree(path, {"state": 0, "next_seg": 0})


def test_cli_resume_reuses_the_saved_segments(data, tmp_path, monkeypatch):
    """`python -m bayesian_ode_tpu_torch.experiments.run --resume` plumbs
    config["resume"] = True to the worker: after a completed checkpointed
    run, the resumed run samples nothing and rewrites the same chain."""
    cfg = dict(GENERIC_CONFIG, method="Ensemble", num_chains=4,
               ckpt_every=2, burn_in=1, num_samples=4)
    blob = {"output": str(tmp_path / "out"), "configs": [cfg],
            "data": {"ode": "vdp", "N": 3, "T": 8, "t_max": 2.0,
                     "seed": 0}}
    (tmp_path / "cfg").mkdir()
    (tmp_path / "cfg" / "1.json").write_text(json.dumps(blob))
    argv = ["--json-dir", str(tmp_path / "cfg"), "--id", "1", "--no-plots",
            "--device", "cpu"]
    cli_main(argv)
    first = dict(_chain(tmp_path / "out"))
    seen = []
    real = vg.samplers.sample_chain

    def counting(*a, **k):
        seen.append(1)
        return real(*a, **k)

    monkeypatch.setattr(vg.samplers, "sample_chain", counting)
    cli_main(argv + ["--resume"])
    # only the structure template's one step on resume: no segment reruns
    assert len(seen) == 1
    second = _chain(tmp_path / "out")
    for k in first:
        np.testing.assert_array_equal(first[k], second[k], err_msg=k)
