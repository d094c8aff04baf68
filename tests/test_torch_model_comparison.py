"""WAIC, the generalized-Pareto fit and PSIS-LOO of the port against the JAX
package on the same seeded (S, N) pointwise log-likelihood matrices.

Gates: float64 to 1e-10 relative (the same arithmetic up to its order);
float32 inputs to 1e-4 relative of the JAX package's float32 result (the
sums of a few hundred float32 terms in two orders), and the Pareto k
(a ratio of such sums) to 1e-3 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.samplers import model_comparison as jmc
from bayesian_ode_tpu_torch.samplers import model_comparison as tmc
from torch_parity import one_torch_thread  # noqa: F401


def ll_matrix(S=200, N=30, seed=0, heavy=True):
    """Pointwise log-likelihoods of N points under S posterior draws of a
    Student-t location model: some points are outliers, so their LOO
    ratios have heavy tails (k above 0.5)."""
    rng = np.random.RandomState(seed)
    y = rng.standard_t(3, size=N) if heavy else rng.randn(N)
    theta = 0.1 * rng.randn(S, 1) + rng.randn(S, 1) * 0.3
    return -0.5 * (y[None] - theta) ** 2 - 0.5 * np.log(2 * np.pi)


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_waic_matches_jax(dtype):
    ll = ll_matrix().astype(dtype)
    want = jax.jit(jmc.waic)(jnp.asarray(ll))
    got = tmc.waic(torch.tensor(ll))
    rtol = 1e-10 if dtype == "float64" else 1e-4
    for g, w in zip(got[:4], want[:4]):
        _close(g, w, rtol, atol=rtol * float(np.max(np.abs(w))))
    assert torch.isnan(got.pareto_k).all()


@pytest.mark.parametrize("n", [6, 25, 60])
def test_gpd_fit_matches_jax(n):
    rng = np.random.RandomState(n)
    x = np.sort(rng.pareto(1.5, size=n) + 1e-3)
    k_w, s_w = jmc.gpd_fit(jnp.asarray(x))
    k_g, s_g = tmc.gpd_fit(torch.tensor(x))
    _close(k_g, k_w, 1e-10)
    _close(s_g, s_w, 1e-10)
    # the batched form fits each column on its own
    X = np.stack([x, np.sort(rng.exponential(size=n))], axis=1)
    k_b, s_b = tmc.gpd_fit(torch.tensor(X))
    for j in range(2):
        k_j, s_j = jmc.gpd_fit(jnp.asarray(X[:, j]))
        _close(k_b[j], k_j, 1e-10)
        _close(s_b[j], s_j, 1e-10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("S", [30, 200])
def test_psis_loo_matches_jax(dtype, S):
    ll = ll_matrix(S=S).astype(dtype)
    want = jax.jit(jmc.psis_loo)(jnp.asarray(ll))
    got = tmc.psis_loo(torch.tensor(ll))
    rtol = 1e-10 if dtype == "float64" else 1e-4
    for g, w in zip(got[:4], want[:4]):
        _close(g, w, rtol, atol=rtol * float(np.max(np.abs(w))))
    _close(got.pareto_k, want.pareto_k, 0.0,
           atol=1e-10 if dtype == "float64" else 1e-3)
    assert float(got.pareto_k.max()) > 0.5      # some tails are heavy


def test_chain_axis_compare_and_the_draw_floor():
    ll = ll_matrix(S=120)
    folded = torch.tensor(ll.reshape(40, 3, -1))
    a, b = tmc.psis_loo(folded), tmc.psis_loo(torch.tensor(ll))
    _close(a.elpd, b.elpd, 1e-12)
    other = tmc.waic(torch.tensor(ll_matrix(S=120, seed=1)))
    got = tmc.compare(b, other)
    want = jmc.compare(jax.jit(jmc.psis_loo)(jnp.asarray(ll)),
                       jax.jit(jmc.waic)(jnp.asarray(ll_matrix(S=120,
                                                               seed=1))))
    _close(got.elpd_diff, want.elpd_diff, 1e-10)
    _close(got.se_diff, want.se_diff, 1e-10)
    assert bool(got.better) == bool(want.better)
    with pytest.raises(ValueError, match="25 draws"):
        tmc.psis_loo(torch.tensor(ll[:20]))
    with pytest.raises(ValueError, match="same data points"):
        tmc.compare(b, tmc.waic(torch.tensor(ll[:, :5])))
