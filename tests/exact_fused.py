"""The exact and population samplers through both drivers' fused GP
engines, for `test_torch_exact_fused_hmc.py` (AdaptiveHMC at rk4) and
`test_torch_exact_fused_population.py` (Ensemble at rk4): one file a
family, so that they spread over the suite's workers.  Each case compiles
the JAX package's fused kernels in interpret mode, 20-220 s a case under
the suite's load (HMC at dopri5 took 224 s, AdaptiveNUTS at rk4 121 s),
so the other method-and-solver pairs are not run here: their sampler code
is held to JAX in float64 on the generic engine
(test_torch_exact_driver.py and the kernels' files), the fused
potentials in float32 by test_torch_slice.py and the fused-engine files,
and the card runs all six methods on the fused engine (chip_smoke.py
phases 24-25).

Both drivers run the batched kernels on the fused potential (the JAX
driver's Pallas kernels in interpret mode, the port's kernels' plain
versions on the CPU) in float32, 128 chains (Ensemble: 256 walkers) from
the same jittered start, with the draws fixed in both packages
(`fixed_draws.py`).  Gate: the kept potentials to 1e-4 relative, the gate
of test_torch_slice.py for two float32 solves whose meshes differ by
rounding; the accept masks' means and the summary's keys equal.  The
adaptive methods' warmup turns log alpha, a float32 difference of
potentials near 600 (the two packages' potentials differ by about 6e-6
relative, a few 1e-3 absolute), into the next log step size with gain
sqrt(t) / (gamma (t + t0)), about 2 at the first step, so their step
sizes differ by up to about 1e-2 after the warmup and their potentials
are held to 2e-2 (measured: 7.1e-3 on 5 of 384).

At dopri5 a gradient differs by about 1e-3 between the two packages'
float32 step meshes (test_torch_slice.py): HMC's Metropolis test and the
stretch move take that in their stride over a few steps, but NUTS's tree
decisions and PT's swaps flip on a few chains (a 128-chain NUTS run: 7
of 512 kept potentials off by up to 8%) and the warmup moves its step
sizes by percent (4.6%); HMC held there (1e-4) when it was run.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import torch

import fixed_draws
from bayesian_ode_tpu.experiments.vanderpol_gp import run_sampler as jrun
from bayesian_ode_tpu_torch.experiments.vanderpol_gp import run_sampler
from torch_parity import GENERIC_CONFIG, gp_problem

tham = importlib.import_module("bayesian_ode_tpu_torch.samplers.hamiltonian")
tnuts = importlib.import_module("bayesian_ode_tpu_torch.samplers.nuts")

# step sizes at which moves are accepted on this posterior
LR = {"AdaptiveHMC": 1e-5, "Ensemble": 1e-4}


def xla_exp(x):
    return torch.tensor(np.asarray(jnp.exp(jnp.asarray(x.numpy()))))


def check_fused_method(method, solver, tmp_path, monkeypatch):
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch)
    monkeypatch.setattr(tham, "_step_of", xla_exp)
    monkeypatch.setattr(tnuts, "_step_of", xla_exp)
    p = gp_problem()
    data = {"x0": p["x0"], "t": p["t"], "Y": p["Y"], "noise": 0.05}
    adaptive = method.startswith("Adaptive")
    # no burn-in but for the warmup: one compiled step in the JAX driver
    cfg = dict(GENERIC_CONFIG, method=method, engine="fused", solver=solver,
               M=6, num_chains=100, burn_in=2 if adaptive else 0,
               num_samples=3 if adaptive else 4, lr=LR[method],
               num_leapfrog=2, max_depth=2, num_replicas=2, beta_min=0.25,
               jitter=0.003)
    got = run_sampler(cfg, data, str(tmp_path / "port"), make_plots=False,
                      device="cpu")
    want = jrun(cfg, data, str(tmp_path / "jax"), make_plots=False)
    assert set(got) == set(want)
    assert got["num_chains"] == want["num_chains"] == (
        256 if method == "Ensemble" else 128)
    out = lambda root: tmp_path / root / method / "1"  # noqa: E731
    pots = np.load(out("port") / "total_loss_arr.npy")
    assert pots.shape == (got["num_chains"], cfg["num_samples"])
    assert np.isfinite(pots).all()
    np.testing.assert_allclose(pots,
                               np.load(out("jax") / "total_loss_arr.npy"),
                               rtol=2e-2 if adaptive else 1e-4)
    assert got["acceptance"] == want["acceptance"]
    assert got["acceptance"] > 0
    if method == "PT":
        assert got["swap_acceptance"] == want["swap_acceptance"]
