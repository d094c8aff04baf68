"""The port's HAMCMC (`samplers/hamcmc.py`) against the JAX package's, in
float64 on the CPU: the matrix-free factor products against JAX and the
dense BFGS oracle, pair filtering, `hamcmc_batched` step for step against
the JAX per-chain kernel under `jax.vmap` (every variant, through the
warm-up and the metric steps, with the Metropolis correction), the
per-chain kernel against the batched one, the moments on a Gaussian, and
method="HAMCMC1" through the driver against the JAX driver.

Gates.  The products to 1e-12 relative of JAX's (the same recursions up
to the order of each dot product's sum) and to 1e-8 of the dense oracle
(the JAX package's gate).  Whole runs to 1e-9: deterministic steps
(add_noise=False, or every normal and uniform draw zeroed in both
packages), where only rounding separates the two.  Moments at the JAX
package's Gaussian gates (tests/test_samplers.py).
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
from torch_parity import (  # noqa: F401
    GENERIC_CONFIG,
    generic_data,
    one_torch_thread,
)

# the modules (each package's `samplers.hamcmc` name is the kernel)
jh = importlib.import_module("bayesian_ode_tpu.samplers.hamcmc")
th = importlib.import_module("bayesian_ode_tpu_torch.samplers.hamcmc")

F64 = torch.float64


def _pairs(C=3, n_pairs=4, P=6, seed=0):
    """C chains of exact-curvature pairs y = A s (A SPD), with a few
    pairs of each chain masked out or of negative curvature."""
    rng = np.random.RandomState(seed)
    A = rng.randn(P, P)
    A = A @ A.T + P * np.eye(P)
    s = rng.randn(C, n_pairs, P)
    y = s @ A.T
    y[1, 2] = -s[1, 2]                      # s'y < 0: skipped
    valid = np.ones((C, n_pairs), bool)
    valid[2, :2] = False
    return s, y, valid, rng.randn(C, P), rng.randn(C, P)


def _jvmap_products(s, y, valid, H_gamma, g, n):
    return jax.vmap(lambda a, b, c, d, e: jh.hamcmc_products(
        a, b, c, H_gamma, d, e))(*map(jnp.asarray, (s, y, valid, g, n)))


@pytest.mark.parametrize("H_gamma", [1.0, 2.0])
def test_products_match_jax_and_the_dense_oracle(H_gamma):
    s, y, valid, g, n = _pairs()
    Hg, Sn = samplers.hamcmc_products(*map(torch.tensor, (s, y, valid)),
                                      H_gamma, torch.tensor(g),
                                      torch.tensor(n))
    jHg, jSn = _jvmap_products(s, y, valid, H_gamma, g, n)
    np.testing.assert_allclose(Hg.numpy(), np.asarray(jHg), rtol=1e-12)
    np.testing.assert_allclose(Sn.numpy(), np.asarray(jSn), rtol=1e-12)
    Bz = samplers.hamcmc_B_product(*map(torch.tensor, (s, y, valid)),
                                   H_gamma, torch.tensor(g))
    jBz = jax.vmap(lambda a, b, c, d: jh.hamcmc_B_product(
        a, b, c, H_gamma, d))(*map(jnp.asarray, (s, y, valid, g)))
    np.testing.assert_allclose(Bz.numpy(), np.asarray(jBz), rtol=1e-12)

    H = samplers.hamcmc_dense_oracle(*map(torch.tensor, (s, y, valid)),
                                     H_gamma)
    jH = jax.vmap(lambda a, b, c: jh.hamcmc_dense_oracle(a, b, c, H_gamma))(
        *map(jnp.asarray, (s, y, valid)))
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=1e-12,
                               atol=1e-14)
    for c in range(s.shape[0]):
        Hc = H[c].numpy()
        # H g by the recursion equals the dense product
        np.testing.assert_allclose(Hg[c].numpy(), Hc @ g[c], rtol=1e-8,
                                   atol=1e-8)
        # B = H^-1 and S S^T = H
        np.testing.assert_allclose(Hc @ Bz[c].numpy(), g[c], rtol=1e-8,
                                   atol=1e-8)
        S = torch.stack([samplers.hamcmc_products(
            *map(torch.tensor, (s[c], y[c], valid[c])), H_gamma,
            torch.zeros(6, dtype=F64), torch.eye(6, dtype=F64)[i])[1]
            for i in range(6)], dim=1).numpy()
        np.testing.assert_allclose(S @ S.T, Hc, rtol=1e-7, atol=1e-8)
    # no valid pair: H0 = H_gamma I, S0 = sqrt(H_gamma) I
    none = np.zeros_like(valid)
    Hg0, Sn0 = samplers.hamcmc_products(*map(torch.tensor, (s, y, none)),
                                        H_gamma, torch.tensor(g),
                                        torch.tensor(g))
    np.testing.assert_allclose(Hg0.numpy(), H_gamma * g, rtol=1e-12)
    np.testing.assert_allclose(Sn0.numpy(), np.sqrt(H_gamma) * g,
                               rtol=1e-12)


def test_pair_filtering():
    """Pairs with s'y <= 0 leave H untouched."""
    s = np.random.RandomState(1).randn(2, 4)
    H = samplers.hamcmc_dense_oracle(torch.tensor(s), torch.tensor(-s),
                                     torch.ones(2, dtype=torch.bool), 1.0)
    np.testing.assert_allclose(H.numpy(), np.eye(4))


# an anisotropic quadratic over a two-leaf tree {'x': (d,), 'y': ()}
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
    return 0.5 * x @ jnp.asarray(PREC) @ x - x @ jnp.asarray(BVEC) \
        + 1.5 * y ** 2


def _start(C=5, seed=2):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(C, D), "y": rng.randn(C)}


def _run_both(steps, **kw):
    """`hamcmc_batched` on the port and `hamcmc` under jax.vmap on JAX,
    from the same start: per step, the positions, potentials, pair counts
    and metric flags."""
    pos = _start()
    C = pos["y"].shape[0]
    tk = samplers.hamcmc_batched(_pot_t, **kw)
    ts = tk.init({k: torch.tensor(v) for k, v in pos.items()})
    jk = jsamplers.hamcmc(_pot_j, **kw)
    js = jax.vmap(jk.init)(jax.tree.map(jnp.asarray, pos))
    jstep = jax.jit(jax.vmap(jk.step))
    keys = jax.random.split(jax.random.PRNGKey(0), C)
    gen = torch.Generator().manual_seed(0)
    out = []
    for _ in range(steps):
        ts, ti = tk.step(gen, ts)
        js, ji = jstep(keys, js)
        out.append((ts, ti, js, ji))
    return out


def _check_step(ts, ti, js, ji):
    for k in ("x", "y"):
        np.testing.assert_allclose(ts.position[k].numpy(),
                                   np.asarray(js.position[k]), rtol=1e-9,
                                   atol=1e-12)
    np.testing.assert_allclose(ti["potential"].numpy(),
                               np.asarray(ji["potential"]), rtol=1e-9)
    assert ti["n_pairs"].tolist() == np.asarray(ji["n_pairs"]).tolist()
    assert ti["accepted"].tolist() == np.asarray(ji["accepted"]).tolist()
    assert bool(np.all(np.asarray(ji["using_metric"])
                       == ti["using_metric"]))
    np.testing.assert_allclose(ts.s_buf.numpy(), np.asarray(js.s_buf),
                               rtol=1e-9, atol=1e-12)
    assert ts.pair_valid.tolist() == np.asarray(js.pair_valid).tolist()


@pytest.mark.parametrize("variant", [1, 2, 3, 4])
def test_batched_matches_jax_under_vmap(variant):
    """memory=2 (M=3), warm-up 2 + K steps, then the metric steps."""
    steps = 18
    out = _run_both(steps, step_size=0.05, memory=2, variant=variant,
                    warmup_extra=2, add_noise=False)
    K = 5 if variant == 1 else 3
    for i, (ts, ti, js, ji) in enumerate(out):
        _check_step(ts, ti, js, ji)
        assert ti["using_metric"] == (i >= 2 + K)
    assert out[-1][1]["n_pairs"].min() > 0
    assert ts.filled == K and ts.step == steps


@pytest.mark.parametrize("variant", [1, 3])
def test_metropolis_matches_jax_with_zero_uniforms(variant, monkeypatch):
    """accept_reject=True with both packages' uniforms at 0: every finite
    proposal is accepted, after the extra gradient and the two quadratic
    forms of the test."""
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, *a, **k: jnp.zeros(()))
    monkeypatch.setattr(th.torch, "rand",
                        lambda shape, **k: torch.zeros(shape, **{
                            n: v for n, v in k.items()
                            if n in ("dtype", "device")}))
    for ts, ti, js, ji in _run_both(14, step_size=0.05, memory=2,
                                    variant=variant, warmup_extra=1,
                                    add_noise=False, accept_reject=True):
        _check_step(ts, ti, js, ji)


def test_metropolis_rejection_restores_the_base_entry(monkeypatch):
    """With the uniforms at 1 (log u = 0) a chain accepts only a move of
    positive log-alpha; a rejected chain restarts from its base entry
    (variant 3: its position before the step)."""
    monkeypatch.setattr(th.torch, "rand",
                        lambda shape, **k: torch.ones(shape, **{
                            n: v for n, v in k.items()
                            if n in ("dtype", "device")}))
    kern = samplers.hamcmc_batched(_pot_t, 0.3, memory=2, variant=3,
                                   warmup_extra=0, accept_reject=True)
    state = kern.init({k: torch.tensor(v) for k, v in _start().items()})
    gen = torch.Generator().manual_seed(0)
    n_rejected = 0
    for _ in range(12):
        before = state
        state, info = kern.step(gen, state)
        rejected = ~info["accepted"]
        assert info["using_metric"] or not bool(rejected.any())
        n_rejected += int(rejected.sum())
        for k in ("x", "y"):
            torch.testing.assert_close(state.position[k][rejected],
                                       before.position[k][rejected],
                                       rtol=0, atol=0)
    assert n_rejected > 0


def test_guard_holds_a_divergent_chain_with_its_pairs():
    """`guard_finite_batched` over `hamcmc_batched` (the driver's
    guard_finite): a chain whose new potential is not finite keeps its
    whole state, its pair mask with its pairs; the others move on."""
    calls = [0]

    def pot(p):
        calls[0] += 1
        u = _pot_t(p)
        return torch.where((torch.arange(u.shape[0]) == 1) & (calls[0] == 5),
                           torch.nan, u)

    kern = samplers.guard_finite_batched(samplers.hamcmc_batched(
        pot, 0.05, memory=2, variant=4, warmup_extra=0, add_noise=False))
    state = kern.init({k: torch.tensor(v) for k, v in _start().items()})
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):                 # K = 3 warm-up steps, one pair
        state, info = kern.step(gen, state)
    assert not info["using_metric"] and bool(info["finite"].all())
    before = state
    state, info = kern.step(gen, state)          # the 5th potential call
    assert info["using_metric"]
    assert info["finite"].tolist() == [True, False, True, True, True]
    assert state.pair_valid[:, 0].tolist() == [True, False, True, True,
                                               True]
    for f in ("params_buf", "grads_buf", "pots_buf", "s_buf", "y_buf",
              "pair_valid", "potential"):
        new, old = getattr(state, f), getattr(before, f)
        assert torch.equal(new[1], old[1]), f
        assert not torch.equal(new[0], old[0]), f
    assert state.step == before.step + 1


def test_one_chain_kernel_equals_the_batched_kernel():
    pos = _start(C=3)
    kw = dict(step_size=0.05, memory=2, variant=1, warmup_extra=1)
    batched = samplers.hamcmc_batched(_pot_t, **kw)
    state = batched.init({k: torch.tensor(v) for k, v in pos.items()})
    single = samplers.hamcmc(lambda p: _pot_t(
        {k: v[None] for k, v in p.items()})[0], **kw)
    states = [single.init({k: torch.tensor(v[c]) for k, v in pos.items()})
              for c in range(3)]
    gen = torch.Generator().manual_seed(1)
    for _ in range(12):
        noise = torch.randn((3, D + 1), generator=gen, dtype=F64)
        draws = iter([noise] + [noise[c:c + 1] for c in range(3)])
        real = th.torch.randn
        th.torch.randn = lambda *a, **k: next(draws)
        try:
            state, info = batched.step(gen, state)
            for c in range(3):
                states[c], ic = single.step(gen, states[c])
                assert ic["n_pairs"] == info["n_pairs"][c]
        finally:
            th.torch.randn = real
    for c in range(3):
        for k in ("x", "y"):
            torch.testing.assert_close(states[c].position[k],
                                       state.position[k][c], rtol=1e-12,
                                       atol=1e-12)
        assert states[c].params_buf.shape == state.params_buf.shape[1:]


COV = np.asarray([[1.0, 0.6], [0.6, 0.8]])
GPREC = np.linalg.inv(COV)


def _gauss(p):
    return 0.5 * torch.einsum("ci,ij,cj->c", p,
                              torch.as_tensor(GPREC, dtype=p.dtype), p)


def _moments(kern, seed, C=32, burn=300, samples=1200):
    gen = torch.Generator().manual_seed(seed)
    x0 = torch.randn((C, 2), generator=gen, dtype=F64)
    state, positions, infos = samplers.sample_chain(
        kern, kern.init(x0), gen, num_samples=samples, burn_in=burn)
    flat = positions.reshape(-1, 2).numpy()
    return flat.mean(0), np.cov(flat.T), infos


@pytest.mark.parametrize("variant", [1, 2, 3, 4])
def test_gaussian_moments(variant):
    """The JAX package's gate (tests/test_samplers.py): memory 3, 20 extra
    warm-up steps, 32 chains, 300 + 1200 steps."""
    kern = samplers.hamcmc_batched(_gauss, 0.02, memory=3, variant=variant,
                                   warmup_extra=20)
    mean, cov, infos = _moments(kern, 7 + variant)
    assert bool(infos["using_metric"][-1])
    assert int(infos["n_pairs"].max()) > 0
    assert np.max(np.abs(mean)) < 0.25, mean
    assert np.max(np.abs(cov - COV)) < 0.5, cov


def test_metropolis_gaussian_moments():
    kern = samplers.hamcmc_batched(_gauss, 0.05, memory=3, variant=1,
                                   warmup_extra=20, accept_reject=True)
    mean, cov, infos = _moments(kern, 31, samples=1500)
    acc = float(infos["accepted"][-500:].float().mean())
    assert 0.1 < acc <= 1.0, acc
    assert np.max(np.abs(mean)) < 0.25, mean
    assert np.max(np.abs(cov - COV)) < 0.4, cov


def test_hamcmc_rejects_an_unknown_variant():
    with pytest.raises(ValueError, match="variant"):
        samplers.hamcmc_batched(_gauss, 0.02, variant=5)


@pytest.fixture
def no_noise(monkeypatch):
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float64, *a, **k:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(th.torch, "randn",
                        lambda shape, **k: torch.zeros(shape, **{
                            n: v for n, v in k.items()
                            if n in ("dtype", "device")}))


@pytest.mark.parametrize("method,variant", [("HAMCMC", 1), ("HAMCMC1", 1),
                                            ("HAMCMC2", 2), ("HAMCMC4", 4)])
def test_driver_dispatches_hamcmc_as_the_jax_driver(method, variant,
                                                     monkeypatch):
    """The variant is the method name's last digit (1 without one); memory
    5, trust_reg and H_gamma 1 unless the config says otherwise."""
    from bayesian_ode_tpu_torch.experiments import vanderpol_gp as tv

    seen = {}
    monkeypatch.setattr(tv.samplers, "hamcmc_batched",
                        lambda pot, sched, **kw: seen.update(kw, sched=sched))
    tv._make_kernel(dict(GENERIC_CONFIG, method=method), _pot_t)
    assert seen["variant"] == variant
    assert (seen["memory"], seen["trust_reg"], seen["H_gamma"]) == (5, 1.0,
                                                                    1.0)
    assert seen["sched"](3) == pytest.approx(1e-5 / 103 ** 0.55, rel=1e-15)
    tv._make_kernel(dict(GENERIC_CONFIG, method=method, memory=2,
                         trust_reg=0.5, H_gamma=2.0), _pot_t)
    assert (seen["memory"], seen["trust_reg"], seen["H_gamma"]) == (2, 0.5,
                                                                    2.0)


def test_driver_hamcmc_matches_the_jax_driver(tmp_path, no_noise):
    """method="HAMCMC1" on the generic engine at the JAX driver's defaults
    (memory 5: K = 11, 100 + 11 warm-up steps), 113 steps, so the last two
    are metric steps; every draw zeroed, every chain from the start
    point."""
    method = "HAMCMC1"
    data = generic_data()
    cfg = dict(GENERIC_CONFIG, method=method, num_chains=2, burn_in=108,
               num_samples=5)
    got = run_sampler(cfg, data, str(tmp_path / "port"), make_plots=False,
                      device="cpu", dtype=F64)
    want = jrun(cfg, data, str(tmp_path / "jax"), make_plots=False)
    assert set(got) == set(want) and got["num_chains"] == 2
    for key in ("min_potential", "median_potential", "acceptance"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9)
    out = lambda root: tmp_path / root / method / "1"  # noqa: E731
    np.testing.assert_allclose(np.load(out("port") / "total_loss_arr.npy"),
                               np.load(out("jax") / "total_loss_arr.npy"),
                               rtol=1e-9)
    a = np.load(out("port") / "chain.npz")
    b = np.load(out("jax") / "chain.npz")
    assert str(a["__treedef__"]) == str(b["__treedef__"])
    for k in ("leaf_0", "leaf_1"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-9, atol=1e-12)
