"""The port's stochastic-gradient HMC family (`samplers/hamiltonian.py`:
aSGHMC, acSGHMC, SGRHMC, BAOAB) against the JAX package's, on the CPU:
each batched kernel step for step against its JAX counterpart with the
normal draws zeroed in both packages, the per-chain kernels against the
batched ones, moments on a Gaussian, and the driver's methods against
the JAX driver on the generic engine and on the fused GP rk4 and dopri5
engines.

Gates.  Kernels and the generic driver in float64 to 1e-9: deterministic
steps, only rounding between the packages (acSGHMC's cosine schedule is
float32 in JAX and float64 here, so its runs take lr0 = 1e-6, where the
schedule's rounding moves the positions below the gate, as the generic
cSGLD test does).  The fused driver in float32: potentials to 1e-4
relative, the gate of `test_torch_slice.py` for two float32 solves whose
meshes differ by rounding.  Moments at the JAX package's Gaussian gates
(tests/test_samplers.py).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import samplers as jsamplers
from bayesian_ode_tpu.experiments.vanderpol_gp import run_sampler as jrun
from bayesian_ode_tpu_torch import samplers
from bayesian_ode_tpu_torch.experiments.vanderpol_gp import run_sampler
from bayesian_ode_tpu_torch.utils.pytree import tree_map
from torch_parity import (  # noqa: F401
    GENERIC_CONFIG,
    generic_data,
    gp_problem,
    one_torch_thread,
)

jham = importlib.import_module("bayesian_ode_tpu.samplers.hamiltonian")
tham = importlib.import_module("bayesian_ode_tpu_torch.samplers.hamiltonian")

F64 = torch.float64


@pytest.fixture
def no_noise(monkeypatch):
    monkeypatch.setattr(jham, "tree_random_normal",
                        lambda key, a: jax.tree.map(jnp.zeros_like, a))
    monkeypatch.setattr(tham, "tree_random_normal",
                        lambda gen, a: tree_map(torch.zeros_like, a))


D = 3
_rng = np.random.RandomState(4)
_M = _rng.randn(D, D)
PREC = _M @ _M.T + np.eye(D)
BVEC = _rng.randn(D)


def _pot_t(p):
    x, y = p["x"], p["y"]
    P = torch.as_tensor(PREC, dtype=x.dtype)
    return (0.5 * torch.einsum("ci,ij,cj->c", x, P, x)
            - x @ torch.as_tensor(BVEC, dtype=x.dtype) + 1.5 * y ** 2)


def _pot_j(p):
    x, y = p["x"], p["y"]
    return (0.5 * jnp.einsum("ci,ij,cj->c", x, jnp.asarray(PREC), x)
            - x @ jnp.asarray(BVEC) + 1.5 * y ** 2)


def _start(C=5, seed=2):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(C, D), "y": rng.randn(C)}


KERNELS = {
    "asghmc": ("asghmc_batched", dict(step_size=0.1, burn_in_steps=10,
                                      mom_decay=0.05,
                                      resample_momentum_every=4)),
    "asghmc_quiet": ("asghmc_batched", dict(step_size=0.1, burn_in_steps=10,
                                            add_noise=False)),
    "acsghmc": ("acsghmc_batched", dict(lr0=1e-6, num_cycles=2,
                                        total_iters=30, burn_in_steps=10)),
    "sgrhmc": ("sgrhmc_batched", dict(step_size=0.05, friction=0.3)),
    "baoab": ("baoab_batched", dict(step_size=0.1, friction=1.0,
                                    burn_in_steps=10)),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_batched_kernels_match_jax(name, no_noise):
    fn, kw = KERNELS[name]
    pos = _start()
    tk = getattr(samplers, fn)(_pot_t, **kw)
    jk = getattr(jsamplers, fn)(_pot_j, **kw)
    ts = tk.init({k: torch.tensor(v) for k, v in pos.items()})
    js = jk.init(jax.tree.map(jnp.asarray, pos))
    jstep = jax.jit(jk.step)
    gen = torch.Generator().manual_seed(0)
    for i in range(30):
        ts, ti = tk.step(gen, ts)
        js, ji = jstep(jax.random.PRNGKey(i), js)
        for k in ("x", "y"):
            np.testing.assert_allclose(ts.position[k].numpy(),
                                       np.asarray(js.position[k]),
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(ts.momentum[k].numpy(),
                                       np.asarray(js.momentum[k]),
                                       rtol=1e-9, atol=1e-12)
        # the potential before the step, as in JAX
        np.testing.assert_allclose(ti["potential"].numpy(),
                                   np.asarray(ji["potential"]), rtol=1e-9)
        # acSGHMC: JAX's float32 cosine, lr0/2 (cos(pi r) + 1), to float32
        # rounding of its bracket
        np.testing.assert_allclose(
            ti["step_size"], float(ji["step_size"]),
            rtol=1e-9, atol=1e-7 * kw["lr0"] if name == "acsghmc" else 0)
    assert ts.step == 30


@pytest.mark.parametrize("name", ["asghmc", "acsghmc", "sgrhmc", "baoab"])
def test_one_chain_kernels_equal_the_batched_kernels(name, no_noise):
    fn, kw = KERNELS[name]
    pos = _start(C=3)
    batched = getattr(samplers, fn)(_pot_t, **kw)
    state = batched.init({k: torch.tensor(v) for k, v in pos.items()})
    single = getattr(samplers, fn.replace("_batched", ""))(
        lambda p: _pot_t({k: v[None] for k, v in p.items()})[0], **kw)
    states = [single.init({k: torch.tensor(v[c]) for k, v in pos.items()})
              for c in range(3)]
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        state, info = batched.step(gen, state)
        for c in range(3):
            states[c], ic = single.step(gen, states[c])
            np.testing.assert_allclose(float(ic["potential"]),
                                       float(info["potential"][c]),
                                       rtol=1e-12)
    for c in range(3):
        for k in ("x", "y"):
            torch.testing.assert_close(states[c].position[k],
                                       state.position[k][c], rtol=1e-12,
                                       atol=1e-12)


COV = np.asarray([[1.0, 0.6], [0.6, 0.8]])
GPREC = np.linalg.inv(COV)


def _gauss(p):
    return 0.5 * torch.einsum("ci,ij,cj->c", p,
                              torch.as_tensor(GPREC, dtype=p.dtype), p)


@pytest.mark.parametrize("fn,kw,burn,samples,tol", [
    ("asghmc_batched", dict(step_size=0.1, burn_in_steps=200,
                            mom_decay=0.05), 300, 2000, (0.25, 0.45)),
    ("baoab_batched", dict(step_size=0.3, friction=1.0, burn_in_steps=100),
     300, 1500, (0.15, 0.25)),
    ("sgrhmc_batched", dict(step_size=0.05, friction=0.3), 500, 2000,
     (0.25, 0.45)),
])
def test_gaussian_moments(fn, kw, burn, samples, tol):
    """32 chains on the 2-D Gaussian, the JAX package's gates."""
    kern = getattr(samplers, fn)(_gauss, **kw)
    gen = torch.Generator().manual_seed(5)
    x0 = torch.randn((32, 2), generator=gen, dtype=F64)
    _, positions, infos = samplers.sample_chain(
        kern, kern.init(x0), gen, num_samples=samples, burn_in=burn)
    assert infos["potential"].shape == (samples, 32)
    flat = positions.reshape(-1, 2).numpy()
    assert np.max(np.abs(flat.mean(0))) < tol[0]
    assert np.max(np.abs(np.cov(flat.T) - COV)) < tol[1]


# ---- through the experiment driver ----

@pytest.fixture(scope="module")
def data():
    return generic_data()


def _compare(got, want, port, jax_out, rtol, chains=True):
    assert set(got) == set(want)
    assert got["num_chains"] == want["num_chains"]
    np.testing.assert_allclose(np.load(port / "total_loss_arr.npy"),
                               np.load(jax_out / "total_loss_arr.npy"),
                               rtol=rtol)
    if chains:
        a, b = np.load(port / "chain.npz"), np.load(jax_out / "chain.npz")
        assert str(a["__treedef__"]) == str(b["__treedef__"])
        for k in ("leaf_0", "leaf_1"):
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("method", ["aSGHMC", "acSGHMC", "SGRHMC", "BAOAB"])
def test_generic_driver_matches_the_jax_driver(method, data, tmp_path,
                                               no_noise):
    """The generic engine at the JAX driver's parameters for each method
    (aSGHMC and BAOAB at config lr, acSGHMC at lr0, SGRHMC on the
    polynomial schedule), 1 burn-in step then 3 kept."""
    cfg = dict(GENERIC_CONFIG, method=method, num_chains=3, num_samples=3,
               lr=1e-5, lr0=1e-6, lambda_=1e-5)
    got = run_sampler(cfg, data, str(tmp_path / "port"), make_plots=False,
                      device="cpu", dtype=F64)
    want = jrun(cfg, data, str(tmp_path / "jax"), make_plots=False)
    for key in ("min_potential", "median_potential", "acceptance"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9)
    out = lambda root: tmp_path / root / method / "1"  # noqa: E731
    _compare(got, want, out("port"), out("jax"), 1e-9)


@pytest.mark.parametrize("solver", ["rk4", "dopri5"])
def test_fused_asghmc_matches_the_jax_fused_driver(solver, tmp_path,
                                                   no_noise):
    """aSGHMC on the fused GP engine (the JAX bench's sampler at its
    lr=8e-3 and mom_decay 0.05), 128 chains from the start point, 1 + 3
    steps; the JAX driver runs its Pallas kernels in interpret mode."""
    p = gp_problem()
    data = {"x0": p["x0"], "t": p["t"], "Y": p["Y"], "noise": 0.05}
    cfg = dict(GENERIC_CONFIG, method="aSGHMC", engine="fused",
               solver=solver, M=6, num_chains=128, burn_in=1,
               num_samples=3, lr=8e-3, mom_decay=0.05, lambda_=1e-5)
    got = run_sampler(cfg, data, str(tmp_path / "port"), make_plots=False,
                      device="cpu")
    want = jrun(cfg, data, str(tmp_path / "jax"), make_plots=False)
    assert got["num_chains"] == 128
    out = lambda root: tmp_path / root / "aSGHMC" / "1"  # noqa: E731
    _compare(got, want, out("port"), out("jax"), 1e-4, chains=False)
    pots = np.load(out("port") / "total_loss_arr.npy")
    assert pots.shape == (128, 3) and np.isfinite(pots).all()
