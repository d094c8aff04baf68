"""The port's parallel tempering (`samplers/tempering.py`) against the JAX
package's, on the CPU: the ladder and its validation, PT steps with the
draws fixed in both packages (`fixed_draws.py`) under the MALA and the
HMC inner moves, the swap bookkeeping, the per-chain finite guard over the
replica rows, and the JAX package's physics gates (tests/test_tempering.py:
exactness on a Gaussian, mode hopping where one temperature cannot).

Gates.  Float64 to 1e-9 relative step for step: replica rows, swap rates
and the cold chain's potentials.  The HMC inner move's per-rung step
eps / sqrt(beta_k) is float32 in both packages and XLA computes it as
eps * rsqrt(beta_k), an ulp from torch's division on most rungs: the
1e-9 run takes a ladder of powers of 4, where both are exact, and a
geometric ladder is held to 1e-5 (float32 step sizes).  Statistical
gates are the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixed_draws
from bayesian_ode_tpu import samplers as jsamplers
from bayesian_ode_tpu_torch import samplers
from torch_parity import one_torch_thread  # noqa: F401

F64 = torch.float64
D = 3
_rng = np.random.RandomState(4)
_M = _rng.randn(D, D)
PREC = _M @ _M.T + np.eye(D)


def _pot_t(p):
    x = p["x"]
    P = torch.as_tensor(PREC, dtype=x.dtype)
    return 0.5 * torch.einsum("ci,ij,cj->c", x, P, x) + p["y"] ** 2


def _pot_j(p):
    x = p["x"]
    return (0.5 * jnp.einsum("ci,ij,cj->c", x, jnp.asarray(PREC), x)
            + p["y"] ** 2)


def _start(C=6, seed=2):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(C, D), "y": rng.randn(C)}


@pytest.fixture
def fixed(monkeypatch):
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch)


def test_temperature_ladder():
    b = samplers.temperature_ladder(5, 0.1)
    assert b.dtype == torch.float32 and b.shape == (5,)
    np.testing.assert_array_equal(
        b.numpy(), np.asarray(jsamplers.temperature_ladder(5, 0.1)))
    assert float(b[0]) == 1.0 and abs(float(b[-1]) - 0.1) < 1e-6
    r = (b[1:] / b[:-1]).numpy()
    np.testing.assert_allclose(r, r[0], rtol=1e-5)


def test_ladder_validation():
    pot = lambda x: (x * x).sum()             # noqa: E731
    with pytest.raises(ValueError):
        samplers.temperature_ladder(1, 0.5)
    with pytest.raises(ValueError):
        samplers.parallel_tempering(pot, [0.5, 0.2], 0.1)   # cold != 1
    with pytest.raises(ValueError):
        samplers.parallel_tempering(pot, [1.0, 0.5, 0.7], 0.1)
    with pytest.raises(ValueError):
        samplers.parallel_tempering_batched(pot, [1.0, 0.5], 0.1,
                                            inner="nope")


@pytest.mark.parametrize("inner,K,beta_min,rtol", [
    ("mala", 4, 0.1, 1e-9),
    ("hmc", 4, 1.0 / 64.0, 1e-9),         # powers of 4: exact steps
    ("hmc", 3, 0.2, 1e-5),                # float32 rsqrt vs division
])
@pytest.mark.parametrize("swap_every", [1, 2])
def test_pt_matches_jax(inner, K, beta_min, rtol, swap_every, fixed):
    """12 PT steps of 6 chains with the draws fixed: every replica row,
    the cold chain's potentials and accept masks, and each chain's swap
    rate; swaps happen, some accepted and some not, on the even and the
    odd pairs."""
    kw = dict(inner=inner, num_leapfrog=3, swap_every=swap_every)
    tk = samplers.parallel_tempering_batched(
        _pot_t, samplers.temperature_ladder(K, beta_min), 0.3, **kw)
    jk = jsamplers.parallel_tempering_batched(
        _pot_j, jsamplers.temperature_ladder(K, beta_min), 0.3, **kw)
    pos = _start()
    ts = tk.init({k: torch.tensor(v) for k, v in pos.items()})
    js = jk.init({k: jnp.asarray(v) for k, v in pos.items()})
    jstep = jax.jit(jk.step)
    rates = []
    for i in range(12):
        ts, ti = tk.step(None, ts)
        js, ji = jstep(jax.random.PRNGKey(i), js)
        for k in ("x", "y"):
            np.testing.assert_allclose(ts.inner.position[k].numpy(),
                                       np.asarray(js.inner.position[k]),
                                       rtol=rtol, atol=1e-12)
            np.testing.assert_allclose(ts.inner.grad[k].numpy(),
                                       np.asarray(js.inner.grad[k]),
                                       rtol=rtol, atol=1e-12)
            np.testing.assert_array_equal(ts.position[k].numpy(),
                                          ts.inner.position[k][:6].numpy())
        np.testing.assert_allclose(ti["potential"].numpy(),
                                   np.asarray(ji["potential"]), rtol=rtol)
        np.testing.assert_allclose(ti["swap_accepted"].numpy(),
                                   np.asarray(ji["swap_accepted"]),
                                   rtol=1e-12)
        np.testing.assert_array_equal(ti["accepted"].numpy(),
                                      np.asarray(ji["accepted"]))
        rates.append(ti["swap_accepted"].numpy())
    rates = np.asarray(rates)
    assert ts.step == 12
    assert rates.max() > 0 and rates.min() < rates.max()
    if swap_every == 2:
        assert not rates[0::2].any()            # no swap on odd steps


def test_one_chain_kernel_equals_the_batched_kernel(monkeypatch):
    """With every chain drawing the same fixed values, `parallel_tempering`
    of each chain equals the batched kernel's chains."""
    fixed_draws.patch_torch(monkeypatch, chain_constant=True)
    betas = samplers.temperature_ladder(3, 0.2)
    pos = _start(C=1)
    batched = samplers.parallel_tempering_batched(_pot_t, betas, 0.3)
    state = batched.init({k: torch.tensor(v) for k, v in pos.items()})
    single = samplers.parallel_tempering(
        lambda p: _pot_t({k: v[None] for k, v in p.items()})[0], betas, 0.3)
    one = single.init({k: torch.tensor(v[0]) for k, v in pos.items()})
    for _ in range(10):
        state, info = batched.step(None, state)
        one, i1 = single.step(None, one)
        np.testing.assert_allclose(float(i1["potential"]),
                                   float(info["potential"][0]), rtol=1e-12)
        assert float(i1["swap_accepted"]) == float(info["swap_accepted"][0])
    for k in ("x", "y"):
        torch.testing.assert_close(one.position[k], state.position[k][0],
                                   rtol=1e-12, atol=1e-12)


def test_guard_holds_all_replica_rows_of_a_divergent_chain():
    """`guard_finite_batched` over PT (the driver's guard_finite): a NaN
    in one hot replica row of chain 1 holds all K rows of chain 1 (and its
    cold position); the other chains' rows move on."""
    C, K = 4, 3
    base = samplers.parallel_tempering_batched(
        lambda p: 0.5 * (p * p).sum(-1), samplers.temperature_ladder(K, 0.3),
        0.3)

    def step(generator, state):
        new, info = base.step(generator, state)
        if new.step == 3:
            x = new.inner.position.clone()
            x[2 * C + 1, 0] = float("nan")
            new = new._replace(inner=new.inner._replace(position=x))
        return new, info

    kern = samplers.guard_finite_batched(
        samplers.TransitionKernel(base.init, step), C)
    gen = torch.Generator().manual_seed(0)
    state = kern.init(torch.randn((C, 2), generator=gen, dtype=F64))
    for _ in range(2):
        state, info = kern.step(gen, state)
        assert bool(info["finite"].all())
    before = state
    state, info = kern.step(gen, state)
    assert info["finite"].tolist() == [True, False, True, True]
    rows = [k * C + 1 for k in range(K)]
    for f in ("position", "potential", "grad"):
        new, old = getattr(state.inner, f), getattr(before.inner, f)
        assert torch.equal(new[rows], old[rows]), f
    assert torch.equal(state.position[1], before.position[1])
    assert not torch.equal(state.inner.position[[0, C, 2 * C]],
                           before.inner.position[[0, C, 2 * C]])
    assert state.step == before.step + 1


def _bimodal(x):
    """Two separated Gaussian modes at (-3, -3) and (3, 3), sd 0.5."""
    def logp(m):
        return -0.5 * (((x - m) / 0.5) ** 2).sum(-1)
    return -torch.logaddexp(logp(-3.0), logp(3.0))


def test_pt_hops_modes_where_mala_cannot():
    """All chains start in the left mode; PT recovers the 50/50 split,
    MALA at the same step stays put."""
    betas = samplers.temperature_ladder(6, 0.02)
    gen = torch.Generator().manual_seed(0)
    x0 = -3.0 + 0.3 * torch.randn((16, 2), generator=gen, dtype=F64)
    pt = samplers.parallel_tempering_batched(_bimodal, betas, 0.15)
    _, pos, infos = samplers.sample_chain(pt, pt.init(x0), gen,
                                          num_samples=1200, burn_in=400)
    right = float((pos[..., 0] > 0).double().mean())
    assert 0.35 < right < 0.65
    assert 0.05 < float(infos["swap_accepted"].mean()) < 0.95
    mala = samplers.mala_batched(_bimodal, 0.15)
    _, pos_m, _ = samplers.sample_chain(mala, mala.init(x0), gen,
                                        num_samples=1200, burn_in=400)
    assert float((pos_m[..., 0] > 0).double().mean()) < 0.02


PT_COV = np.asarray([[1.0, 0.6], [0.6, 0.8]])


@pytest.mark.parametrize("inner,step", [("mala", 0.25), ("hmc", 0.3)])
def test_pt_exact_on_gaussian(inner, step):
    """On a unimodal Gaussian the cold chain reproduces the target (the
    exchange keeps each tempered marginal), at the JAX package's gate."""
    prec = torch.as_tensor(np.linalg.inv(PT_COV))
    pt = samplers.parallel_tempering_batched(
        lambda x: 0.5 * torch.einsum("ci,ij,cj->c", x, prec, x),
        samplers.temperature_ladder(4, 0.1), step, inner=inner,
        num_leapfrog=5)
    gen = torch.Generator().manual_seed(2)
    x0 = 0.3 * torch.randn((16, 2), generator=gen, dtype=F64)
    _, pos, _ = samplers.sample_chain(pt, pt.init(x0), gen, num_samples=800,
                                      burn_in=300)
    flat = pos.reshape(-1, 2).numpy()
    assert np.max(np.abs(flat.mean(0))) < 0.12
    assert np.max(np.abs(np.cov(flat.T) - PT_COV)) < 0.15
