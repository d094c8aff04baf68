"""The port's exact HMC and its warmup-adaptive variant
(`samplers/hamiltonian.py`: `_hmc_proposal`, `_warmup_advance`,
`hmc_batched`, `adaptive_hmc_batched` and their one-chain forms) against
the JAX package's, on the CPU.

The two packages' random draws are replaced by the same fixed values
(`fixed_draws.py`), so their steps are deterministic and comparable.

Gates.  Positions, momenta and Hamiltonian errors in float64 to 1e-9
relative.  The warmup's dual-averaging state is float32 in both packages;
XLA's float32 exp is not correctly rounded (it differs from torch's by an
ulp on about one input in ten), so the step-for-step runs route the
port's exp of the float32 log step (`_step_of`, one function) through
XLA's, and then hold the float32 state to the JAX package's exactly and
the float64 positions to 1e-9; with the port's own exp, the log step
sizes stay within 4 float32 ulps of it.  Moments on the correlated
Gaussian at the JAX package's gates (tests/test_samplers.py), their draws
spread over 4x the chains for a quarter of the kept steps.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixed_draws
from bayesian_ode_tpu import samplers as jsamplers
from bayesian_ode_tpu_torch import samplers
from torch_parity import one_torch_thread  # noqa: F401

jham = importlib.import_module("bayesian_ode_tpu.samplers.hamiltonian")
jbase = importlib.import_module("bayesian_ode_tpu.samplers.base")
tham = importlib.import_module("bayesian_ode_tpu_torch.samplers.hamiltonian")
tnuts = importlib.import_module("bayesian_ode_tpu_torch.samplers.nuts")

F64 = torch.float64
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


def _t(pos):
    return {k: torch.tensor(v) for k, v in pos.items()}


def _j(pos):
    return {k: jnp.asarray(v) for k, v in pos.items()}


def xla_exp(x):
    return torch.tensor(np.asarray(jnp.exp(jnp.asarray(x.numpy()))))


@pytest.fixture
def fixed(monkeypatch):
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch)


@pytest.fixture
def xla_rounding(monkeypatch):
    monkeypatch.setattr(tham, "_step_of", xla_exp)
    monkeypatch.setattr(tnuts, "_step_of", xla_exp)


def _close(a, b, rtol=1e-9):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=1e-12)


@pytest.mark.parametrize("jitter", [0.0, 0.3])
@pytest.mark.parametrize("per_chain_eps", [False, True])
def test_hmc_proposal_matches_jax(jitter, per_chain_eps, fixed):
    """One proposal of 5 leapfrogs with the momentum and the jitter fixed:
    the end point, its potential and gradient and log alpha, under an
    anisotropic inverse mass."""
    pos = _start()
    G = {"x": np.asarray([[2.0, 0.5, 1.0]]), "y": np.asarray([0.7])}
    eps = np.asarray([0.1, 0.2, 0.15, 0.05, 0.12], np.float32) \
        if per_chain_eps else 0.15
    tvag = samplers.batch_value_and_grad(_pot_t)
    jvag = jbase.batch_value_and_grad(_pot_j)
    u0, g0 = tvag(_t(pos))
    ju0, jg0 = jvag(_j(pos))
    got = tham._hmc_proposal(
        tvag, _t(pos), u0, g0, None,
        torch.tensor(eps) if per_chain_eps else eps, jitter, _t(G), 5)
    want = jham._hmc_proposal(
        jvag, _j(pos), ju0, jg0, jax.random.PRNGKey(0),
        jnp.asarray(eps) if per_chain_eps else eps, jitter, _j(G), 5, True)
    for k in ("x", "y"):
        _close(got[0][k], want[0][k])
        _close(got[2][k], want[2][k])
    _close(got[1], want[1])
    _close(got[3], want[3])
    assert np.all(np.abs(np.asarray(want[3])) > 1e-6)


def _advance_both(a_probs, num_adapt, adapt_mass=True):
    """Drive both packages' `_warmup_advance` over the same accept
    statistics and positions from one `_adaptive_init` state."""
    C = a_probs.shape[1]
    rng = np.random.RandomState(7)
    pos = {"x": rng.randn(C, D), "y": rng.randn(C)}
    tstate = tham._adaptive_init(
        samplers.batch_value_and_grad(_pot_t), 0.1)(_t(pos))
    jstate = jham._adaptive_init(
        jbase.batch_value_and_grad(_pot_j), 0.1, True)(_j(pos))
    out = []
    for step, a in enumerate(a_probs):
        pos = {k: v + 0.3 * rng.randn(*v.shape) for k, v in pos.items()}
        tn = tham._warmup_advance(tstate, _t(pos), torch.tensor(a),
                                  num_adapt, 0.8, adapt_mass)
        jn = jham._warmup_advance(jstate, _j(pos), jnp.asarray(a),
                                  num_adapt, 0.8, adapt_mass)
        tstate = tstate._replace(
            position=_t(pos), step=step + 1,
            **dict(zip(("log_eps", "log_eps_avg", "h_avg", "mu", "mean",
                        "m2", "mass_g"), tn)))
        jstate = jstate._replace(
            position=_j(pos), step=jnp.asarray(step + 1, jnp.int32),
            **dict(zip(("log_eps", "log_eps_avg", "h_avg", "mu", "mean",
                        "m2", "mass_g"), jn)))
        out.append((tn, jn))
    return out


@pytest.mark.parametrize("adapt_mass", [True, False])
def test_warmup_advance_matches_jax(adapt_mass):
    """A fixed accept-statistic sequence through phase 1, the A/2 switch,
    phase 2 and past the warmup (A = 30, 36 steps, 4 chains): the float32
    dual-averaging state equals the JAX package's bit for bit (host
    float32 scalars where JAX has float32 arrays), the float64 Welford
    moments and the frozen mass to 1e-12."""
    rng = np.random.RandomState(3)
    a_probs = rng.uniform(0.0, 1.0, size=(36, 4))
    a_probs[5, 1] = 0.0                         # a non-finite proposal
    for step, (tn, jn) in enumerate(_advance_both(a_probs, 30, adapt_mass)):
        for got, want in zip(tn[:4], jn[:4]):
            assert got.dtype == torch.float32
            assert str(np.asarray(want).dtype) == "float32"
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"step {step}")
        for got, want in zip(tn[4:], jn[4:]):
            for k in ("x", "y"):
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), rtol=1e-12)
    mass = tn[6]["x"].numpy()
    if adapt_mass:
        assert not np.allclose(mass, 1.0)       # frozen at the A/2 switch
    else:
        np.testing.assert_array_equal(mass, 1.0)


def _run_both(fn, kw, steps, pos=None):
    pos = _start() if pos is None else pos
    tk = getattr(samplers, fn)(_pot_t, **kw)
    jk = getattr(jsamplers, fn)(_pot_j, **kw)
    ts, js = tk.init(_t(pos)), jk.init(_j(pos))
    gen = torch.Generator().manual_seed(0)
    out = []
    for i in range(steps):
        ts, ti = tk.step(gen, ts)
        js, ji = jk.step(jax.random.PRNGKey(i), js)
        out.append((ts, ti, js, ji))
    return out


KERNELS = {
    "hmc": ("hmc_batched", dict(step_size=0.6, num_leapfrog=4)),
    "hmc_jitter": ("hmc_batched", dict(step_size=0.6, num_leapfrog=5,
                                       jitter=0.2)),
    "hmc_precond": ("hmc_batched", dict(
        step_size=0.6, num_leapfrog=4, jitter=0.2,
        precond={"x": np.asarray([[2.0, 0.5, 1.0]]),
                 "y": np.asarray([0.7])})),
    "adaptive_hmc": ("adaptive_hmc_batched", dict(
        num_adapt=16, step_size=0.2, num_leapfrog=4)),
    "adaptive_hmc_init_mass": ("adaptive_hmc_batched", dict(
        num_adapt=12, step_size=0.05, num_leapfrog=3, target_accept=0.7,
        init_mass={"x": np.asarray([2.0, 0.5, 1.0]),
                   "y": np.asarray(0.7)})),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_batched_kernels_match_jax(name, fixed, xla_rounding):
    """24 steps (the adaptive ones through both warmup phases and past
    them), 5 chains, with the draws fixed in both packages: positions,
    potentials and accept masks to 1e-9, the float32 warmup state exactly."""
    fn, kw = KERNELS[name]
    if "precond" in kw:
        kw = dict(kw, precond={k: v for k, v in kw["precond"].items()})
    tkw = {k: ({n: torch.tensor(a) for n, a in v.items()}
               if k in ("precond", "init_mass") else v)
           for k, v in kw.items()}
    jkw = {k: ({n: jnp.asarray(a) for n, a in v.items()}
               if k in ("precond", "init_mass") else v)
           for k, v in kw.items()}
    pos = _start()
    tk, jk = getattr(samplers, fn)(_pot_t, **tkw), \
        getattr(jsamplers, fn)(_pot_j, **jkw)
    ts, js = tk.init(_t(pos)), jk.init(_j(pos))
    gen = torch.Generator().manual_seed(0)
    n_acc = 0
    # eager for the adaptive kernels: XLA's fused float32 arithmetic under
    # jit rounds the warmup state differently from its op-by-op arithmetic
    jstep = jk.step if fn.startswith("adaptive") else jax.jit(jk.step)
    for i in range(24):
        ts, ti = tk.step(gen, ts)
        js, ji = jstep(jax.random.PRNGKey(i), js)
        for k in ("x", "y"):
            _close(ts.position[k], js.position[k])
        _close(ti["potential"], ji["potential"])
        np.testing.assert_array_equal(ti["accepted"].numpy(),
                                      np.asarray(ji["accepted"]))
        n_acc += int(ti["accepted"].sum())
        if fn.startswith("adaptive"):
            for f in ("log_eps", "log_eps_avg", "h_avg", "mu"):
                np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                              np.asarray(getattr(js, f)))
            for k in ("x", "y"):
                _close(ts.mass_g[k], js.mass_g[k])
            _close(ti["step_size"], ji["step_size"], rtol=0)
    assert ts.step == 24
    assert 0 < n_acc < 24 * 5                  # both branches of the test


def test_adaptive_hmc_with_torch_exp_stays_within_float32_ulps(fixed):
    """With the port's own exp (not XLA's), the step sizes stay within a
    few float32 ulps of the JAX package's over the warmup."""
    fn, kw = KERNELS["adaptive_hmc"]
    worst = 0.0
    for ts, ti, js, ji in _run_both(fn, kw, 8):
        worst = max(worst, float(np.max(np.abs(
            ts.log_eps.numpy() - np.asarray(js.log_eps))
            / np.spacing(np.abs(np.asarray(js.log_eps))))))
    assert worst <= 4.0


@pytest.mark.parametrize("name", ["hmc_jitter", "adaptive_hmc"])
def test_one_chain_kernels_equal_the_batched_kernels(name, monkeypatch):
    """With every chain drawing the same fixed values, `hmc` and
    `adaptive_hmc` of each chain equal the batched kernels' chains."""
    fixed_draws.patch_torch(monkeypatch, chain_constant=True)
    fn, kw = KERNELS[name]
    pos = _start(C=3)
    batched = getattr(samplers, fn)(_pot_t, **kw)
    state = batched.init(_t(pos))
    single = getattr(samplers, fn.replace("_batched", ""))(
        lambda p: _pot_t({k: v[None] for k, v in p.items()})[0], **kw)
    states = [single.init({k: torch.tensor(v[c]) for k, v in pos.items()})
              for c in range(3)]
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        state, info = batched.step(gen, state)
        for c in range(3):
            states[c], ic = single.step(gen, states[c])
            assert bool(ic["accepted"]) == bool(info["accepted"][c])
    for c in range(3):
        for k in ("x", "y"):
            torch.testing.assert_close(states[c].position[k],
                                       state.position[k][c], rtol=1e-12,
                                       atol=1e-12)


COV = np.asarray([[1.0, 0.6], [0.6, 0.8]])
GPREC = np.linalg.inv(COV)


def _gauss(x):
    return 0.5 * torch.einsum("ci,ij,cj->c", x,
                              torch.as_tensor(GPREC, dtype=x.dtype), x)


def _check_moments(positions, mean_tol=0.15, cov_tol=0.25):
    """The JAX package's Gaussian gate (tests/test_samplers.py)."""
    flat = positions.reshape(-1, 2).numpy()
    assert np.max(np.abs(flat.mean(0))) < mean_tol
    assert np.max(np.abs(np.cov(flat.T) - COV)) < cov_tol


def _sample(kernel, seed, C=128, num_samples=125, burn_in=100):
    gen = torch.Generator().manual_seed(seed)
    x0 = torch.randn((C, 2), generator=gen, dtype=F64)
    _, positions, infos = samplers.sample_chain(
        kernel, kernel.init(x0), gen, num_samples=num_samples,
        burn_in=burn_in)
    return positions, infos


def test_hmc_batched_gaussian_moments_and_independent_acceptance():
    positions, infos = _sample(
        samplers.hmc_batched(_gauss, 0.35, num_leapfrog=8, jitter=0.2), 21)
    assert infos["accepted"].shape == (125, 128)
    per_chain = infos["accepted"].double().mean(0)
    assert float(per_chain.std()) > 0.0
    assert 0.6 < float(infos["accepted"].double().mean()) <= 1.0
    _check_moments(positions)


def test_hmc_batched_preconditioned_exactness():
    G = torch.tensor([[4.0, 0.25]], dtype=F64)
    positions, infos = _sample(
        samplers.hmc_batched(_gauss, 0.15, num_leapfrog=8, precond=G,
                             jitter=0.2), 23, num_samples=150, burn_in=100)
    assert 0.5 < float(infos["accepted"].double().mean()) <= 1.0
    _check_moments(positions)


def test_adaptive_hmc_batched_moments():
    """Dual averaging walks eps up from 0.01; chains end at their own
    step sizes; the frozen chain has the target's moments."""
    positions, infos = _sample(
        samplers.adaptive_hmc_batched(_gauss, num_adapt=300, step_size=0.01,
                                      num_leapfrog=8), 43, num_samples=100,
        burn_in=300)
    assert infos["accepted"].shape == (100, 128)
    assert 0.6 < float(infos["accepted"].double().mean()) <= 1.0
    assert infos["step_size"].shape[-1] == 128
    assert float(infos["step_size"][-1].std()) > 0.0
    assert float(infos["step_size"].mean()) > 0.1
    _check_moments(positions)


def test_adaptive_hmc_init_mass():
    """The JAX package's seeded-metric gate (tests/test_nuts.py): a
    scale-30/0.1 diagonal Gaussian, warmup from init_mass = scales^2."""
    scales = torch.tensor([30.0, 0.1], dtype=F64)

    def pot(p):
        return 0.5 * torch.sum((p["x"] / scales) ** 2, dim=-1)

    kernel = samplers.adaptive_hmc_batched(
        pot, num_adapt=200, step_size=0.02, num_leapfrog=8,
        init_mass={"x": scales ** 2})
    gen = torch.Generator().manual_seed(3)
    pos0 = {"x": 0.1 * scales * torch.randn((128, 2), generator=gen,
                                            dtype=F64)}
    _, positions, infos = samplers.sample_chain(
        kernel, kernel.init(pos0), gen, num_samples=75, burn_in=200)
    got = positions["x"].reshape(-1, 2).std(0).numpy()
    np.testing.assert_allclose(got, scales.numpy(), rtol=0.25)
    assert float(infos["accepted"][-25:].double().mean()) > 0.5


def test_guard_holds_the_warmup_state_of_a_divergent_chain():
    """`guard_finite_batched` over `adaptive_hmc_batched` (the driver's
    guard_finite): the Metropolis test already rejects a non-finite
    proposal, so the step is made to leave a NaN in one chain's step size
    (as an overflow would): that chain keeps its whole state, its position
    with its per-chain warmup state (log_eps, h_avg, mu, the Welford
    moments, the mass); the other chains move on."""
    base = samplers.adaptive_hmc_batched(_gauss, num_adapt=10,
                                         step_size=0.3, num_leapfrog=3)

    def step(generator, state):
        new, info = base.step(generator, state)
        if new.step == 4:
            log_eps = new.log_eps.clone()
            log_eps[1] = float("nan")
            new = new._replace(log_eps=log_eps)
        return new, info

    kern = samplers.guard_finite_batched(
        samplers.TransitionKernel(base.init, step))
    gen = torch.Generator().manual_seed(0)
    state = kern.init(torch.randn((3, 2), generator=gen, dtype=F64))
    for _ in range(3):
        state, info = kern.step(gen, state)
        assert bool(info["finite"].all())
    before = state
    state, info = kern.step(gen, state)
    assert info["finite"].tolist() == [True, False, True]
    for f in ("position", "potential", "grad", "log_eps", "log_eps_avg",
              "h_avg", "mu", "mean", "m2", "mass_g"):
        new, old = getattr(state, f), getattr(before, f)
        assert torch.equal(new[1], old[1]), f
    for f in ("log_eps", "h_avg", "mean", "m2"):
        assert not torch.equal(getattr(state, f)[0],
                               getattr(before, f)[0]), f
    assert state.step == before.step + 1
