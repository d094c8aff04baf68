"""The port's NUTS (`samplers/nuts.py`) against the JAX package's, on the
CPU: the bit helpers of the checkpoint scheme, transitions step for step
with the draws fixed in both packages (`fixed_draws.py`), the warmup-
adaptive kernel over its warmup, and the JAX package's NUTS gates
(tests/test_nuts.py: moments, exactness at a large step, the energy
identity, divergences, trajectory length; their draws spread over 4x the
chains for a quarter of the steps, the same number of draws for a
quarter of the host loop).

Gates.  Float64 positions, potentials and accept statistics to 1e-9
relative; tree depths, leapfrog counts, divergence flags and accept masks
equal.  The adaptive kernel's float32 step sizes go through XLA's exp in
the step-for-step run, as in test_torch_hmc.py (XLA's float32 exp is not
correctly rounded), and its float32 warmup state then equals the JAX
package's.  The statistical gates are the JAX package's.
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

jnuts = importlib.import_module("bayesian_ode_tpu.samplers.nuts")
jbase = importlib.import_module("bayesian_ode_tpu.samplers.base")
tham = importlib.import_module("bayesian_ode_tpu_torch.samplers.hamiltonian")
tnuts = importlib.import_module("bayesian_ode_tpu_torch.samplers.nuts")

F64 = torch.float64
D = 3
_rng = np.random.RandomState(4)
_M = _rng.randn(D, D)
PREC = _M @ _M.T + np.eye(D)


def _pot_t(p):
    x, y = p["x"], p["y"]
    P = torch.as_tensor(PREC, dtype=x.dtype)
    return (0.5 * torch.einsum("ci,ij,cj->c", x, P, x)
            + 2.0 * (y ** 2).sum(-1))


def _pot_j(p):
    x, y = p["x"], p["y"]
    return (0.5 * jnp.einsum("ci,ij,cj->c", x, jnp.asarray(PREC), x)
            + 2.0 * (y ** 2).sum(-1))


def _start(C=6, seed=2):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(C, D), "y": rng.randn(C, 2)}


@pytest.fixture
def fixed(monkeypatch):
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch)


def xla_exp(x):
    return torch.tensor(np.asarray(jnp.exp(jnp.asarray(x.numpy()))))


def test_bit_helpers_on_every_int_to_2_10():
    n = torch.arange(2 ** 10, dtype=torch.int32)
    pop = tnuts._popcount(n, 11)
    trail = tnuts._trailing_ones(n, 11)
    assert pop.tolist() == [bin(i).count("1") for i in range(2 ** 10)]
    assert trail.tolist() == [len(bin(i)) - len(bin(i).rstrip("1"))
                              for i in range(2 ** 10)]
    jn = jnp.arange(2 ** 10, dtype=jnp.int32)
    np.testing.assert_array_equal(pop.numpy(),
                                  np.asarray(jnuts._popcount(jn, 11)))
    np.testing.assert_array_equal(trail.numpy(),
                                  np.asarray(jnuts._trailing_ones(jn, 11)))


def _close(a, b, rtol=1e-9):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=1e-12)


@pytest.mark.parametrize("eps,max_depth,max_delta", [
    (0.3, 5, 1000.0),            # U-turns at several depths
    (0.05, 3, 1000.0),           # every tree to max depth
    (1.1, 5, 0.5),               # divergences
])
def test_transition_matches_jax(eps, max_depth, max_delta, fixed):
    """One transition from the same state with the draws fixed: the same
    depth, leapfrog count, divergence flag and moved mask per chain, the
    same selected point and accept statistic."""
    pos = _start()
    tvag = samplers.batch_value_and_grad(_pot_t)
    jvag = jbase.batch_value_and_grad(_pot_j)
    tflat, tunflat = tnuts._flatteners({k: torch.tensor(v)
                                        for k, v in pos.items()})
    jflat, junflat = jnuts._flatteners({k: jnp.asarray(v)
                                        for k, v in pos.items()}, True)
    q0t = tflat({k: torch.tensor(v) for k, v in pos.items()})
    q0j = jflat({k: jnp.asarray(v) for k, v in pos.items()})
    u0t, g0t = tvag(tunflat(q0t))
    u0j, g0j = jvag(junflat(q0j))
    G = np.linspace(0.5, 2.0, q0t.shape[1])[None].repeat(6, 0)

    def tvf(q):
        u, g = tvag(tunflat(q))
        return u, tflat(g)

    def jvf(q):
        u, g = jvag(junflat(q))
        return u, jflat(g)

    qt, ut, gt, it = tnuts._nuts_transition(
        tvf, None, q0t, u0t, tflat(g0t), eps, torch.tensor(G), max_depth,
        max_delta)
    qj, uj, gj, ij = jnuts._nuts_transition(
        jvf, jax.random.PRNGKey(0), q0j, u0j, jflat(g0j), eps,
        jnp.asarray(G), max_depth, max_delta)
    for k in ("depth", "n_leapfrog", "diverging", "accepted"):
        np.testing.assert_array_equal(it[k].numpy(), np.asarray(ij[k]),
                                      err_msg=k)
    _close(qt, qj)
    _close(ut, uj)
    _close(gt, gj)
    _close(it["accept_prob"], ij["accept_prob"])
    if max_delta < 1.0:
        assert it["diverging"].any()
    else:
        assert not it["diverging"].any()
    if max_depth == 3:
        assert (it["depth"] == 3).all() and (it["n_leapfrog"] == 7).all()
    elif max_delta > 1.0:
        assert len(set(it["depth"].tolist())) > 1


@pytest.mark.parametrize("fn,kw", [
    ("nuts_batched", dict(step_size=0.3, max_depth=5)),
    ("nuts_batched", dict(step_size=0.3, max_depth=4,
                          precond={"x": np.asarray([[2.0, 0.5, 1.0]]),
                                   "y": np.asarray([[0.7, 1.3]])})),
    ("adaptive_nuts_batched", dict(num_adapt=16, step_size=0.3,
                                   max_depth=4)),
])
def test_batched_kernels_match_jax(fn, kw, fixed, monkeypatch):
    """20 steps of 6 chains (the adaptive kernel through both warmup
    phases and past them), step for step."""
    monkeypatch.setattr(tham, "_step_of", xla_exp)
    monkeypatch.setattr(tnuts, "_step_of", xla_exp)
    pre = kw.get("precond")
    tk = getattr(samplers, fn)(_pot_t, **dict(kw, **(
        {"precond": {k: torch.tensor(v) for k, v in pre.items()}}
        if pre else {})))
    jk = getattr(jsamplers, fn)(_pot_j, **dict(kw, **(
        {"precond": {k: jnp.asarray(v) for k, v in pre.items()}}
        if pre else {})))
    pos = _start()
    ts = tk.init({k: torch.tensor(v) for k, v in pos.items()})
    js = jk.init({k: jnp.asarray(v) for k, v in pos.items()})
    depths = set()
    # eager for the adaptive kernels: XLA's fused float32 arithmetic under
    # jit rounds the warmup state differently from its op-by-op arithmetic
    jstep = jk.step if fn.startswith("adaptive") else jax.jit(jk.step)
    for i in range(20):
        ts, ti = tk.step(None, ts)
        js, ji = jstep(jax.random.PRNGKey(i), js)
        for k in ("x", "y"):
            _close(ts.position[k], js.position[k])
        _close(ti["potential"], ji["potential"])
        for k in ("depth", "n_leapfrog", "diverging", "accepted"):
            np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]))
        depths |= set(ti["depth"].tolist())
        if fn.startswith("adaptive"):
            for f in ("log_eps", "log_eps_avg", "h_avg", "mu"):
                np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                              np.asarray(getattr(js, f)))
    assert len(depths) > 1
    assert ts.step == 20


def test_one_chain_kernel_equals_the_batched_kernel(monkeypatch):
    """With every chain drawing the same fixed values, `nuts` of each
    chain equals the batched kernel's chains."""
    fixed_draws.patch_torch(monkeypatch, chain_constant=True)
    pos = _start(C=3)
    batched = samplers.nuts_batched(_pot_t, 0.3, max_depth=4)
    state = batched.init({k: torch.tensor(v) for k, v in pos.items()})
    single = samplers.nuts(
        lambda p: _pot_t({k: v[None] for k, v in p.items()})[0], 0.3,
        max_depth=4)
    states = [single.init({k: torch.tensor(v[c]) for k, v in pos.items()})
              for c in range(3)]
    for _ in range(10):
        state, info = batched.step(None, state)
        for c in range(3):
            states[c], ic = single.step(None, states[c])
            assert int(ic["n_leapfrog"]) == int(info["n_leapfrog"][c])
    for c in range(3):
        for k in ("x", "y"):
            torch.testing.assert_close(states[c].position[k],
                                       state.position[k][c], rtol=1e-12,
                                       atol=1e-12)


COV = np.asarray([[1.0, 0.8], [0.8, 1.0]])
GPREC = np.linalg.inv(COV)


def _gauss(x):
    return 0.5 * torch.einsum("ci,ij,cj->c", x,
                              torch.as_tensor(GPREC, dtype=x.dtype), x)


def _run(kernel, seed, C=128, num_samples=100, burn_in=100, dim=2,
         jitter=1.0):
    gen = torch.Generator().manual_seed(seed)
    x0 = jitter * torch.randn((C, dim), generator=gen, dtype=F64)
    _, positions, infos = samplers.sample_chain(
        kernel, kernel.init(x0), gen, num_samples=num_samples,
        burn_in=burn_in)
    return positions, infos


def _check_moments(positions, mean_tol=0.12, cov_tol=0.2):
    flat = positions.reshape(-1, 2).numpy()
    assert np.max(np.abs(flat.mean(0))) < mean_tol
    assert np.max(np.abs(np.cov(flat.T) - COV)) < cov_tol


def test_nuts_correlated_gaussian_moments():
    positions, infos = _run(samplers.nuts_batched(_gauss, 0.4), 0)
    _check_moments(positions)
    assert float(infos["depth"].double().mean()) > 1.5
    assert not infos["diverging"].any()
    # per-chain trees: depths differ across chains within a step
    assert float(infos["depth"].double().std(dim=1).max()) > 0


def test_nuts_exact_at_large_step():
    positions, infos = _run(samplers.nuts_batched(_gauss, 0.9), 1,
                            num_samples=150)
    _check_moments(positions, mean_tol=0.15, cov_tol=0.25)
    assert 0.3 < float(infos["accept_prob"].mean()) < 1.0


def test_nuts_trajectory_scales_with_target_width():
    """The U-turn criterion adapts the trajectory to the target's width:
    the same eps on a 10x wider target gives deeper trees."""
    _, info_n = _run(samplers.nuts_batched(
        lambda x: 0.5 * (x * x).sum(-1), 0.3), 4, C=16, num_samples=40,
        burn_in=20)
    _, info_w = _run(samplers.nuts_batched(
        lambda x: 0.5 * ((x / 10.0) ** 2).sum(-1), 0.3, max_depth=9), 4,
        C=16, num_samples=40, burn_in=20, jitter=5.0)
    d_n = float(info_n["depth"].double().mean())
    d_w = float(info_w["depth"].double().mean())
    assert d_w > d_n + 2.0
    assert float(info_w["n_leapfrog"].double().mean()) > 30


def test_nuts_energy_identity():
    """E[U] = d/2 for a standard Gaussian (exactness, not only moments)."""
    d = 4
    _, infos = _run(samplers.nuts_batched(lambda x: 0.5 * (x * x).sum(-1),
                                          0.5), 5, num_samples=125, dim=d)
    assert abs(float(infos["potential"].mean()) - d / 2) < 0.12


def test_nuts_divergence_flagged_and_frozen():
    """A cliff at |x| > 3 blows up the energy: transitions into it are
    flagged diverging and the chain stays at a finite state."""
    def pot(x):
        r2 = (x * x).sum(-1)
        return 0.5 * r2 + torch.where(r2 > 9.0, 1e8 * (r2 - 9.0),
                                      torch.zeros_like(r2))

    positions, infos = _run(samplers.nuts_batched(pot, 0.6), 6, C=64,
                            num_samples=100, burn_in=0, jitter=2.0)
    assert torch.isfinite(positions).all()
    assert infos["diverging"].any()


def test_adaptive_nuts_init_mass():
    """The JAX package's seeded-metric gate: a scale 30/0.1/1 diagonal
    Gaussian, warmup from init_mass = scales^2."""
    scales = torch.tensor([30.0, 0.1, 1.0], dtype=F64)

    def pot(p):
        return 0.5 * torch.sum((p["x"] / scales) ** 2, dim=-1)

    kernel = samplers.adaptive_nuts_batched(
        pot, num_adapt=150, step_size=0.02, max_depth=8,
        init_mass={"x": scales ** 2})
    gen = torch.Generator().manual_seed(3)
    pos0 = {"x": 0.1 * scales * torch.randn((16, 3), generator=gen,
                                            dtype=F64)}
    _, positions, _ = samplers.sample_chain(
        kernel, kernel.init(pos0), gen, num_samples=150, burn_in=150)
    got = positions["x"].reshape(-1, 3).std(0).numpy()
    np.testing.assert_allclose(got, scales.numpy(), rtol=0.25)
