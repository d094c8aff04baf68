"""Manifold MALA and its metrics (SoftAbs, Hessian, identity) of the port
against the JAX package, in float64 on the CPU.

`sqrtMetric` and `sqrtinvMetric` of SoftAbs are V f(lambda), whose column
signs `eigh` chooses freely, so SoftAbs is held to the JAX package through
sign-invariant products: Metric, invMetric, S S^T of both square roots and
the log-determinant.  Step-for-step checks use zero proposal noise
(add_noise=False, every move the metric drift) or the Hessian metric,
whose Cholesky square root is unique; noisy MMALA is held by its moments
on a correlated Gaussian, as the JAX package's test_samplers.py holds it.
Gates: 1e-10 relative (1e-9 for the accept/reject chain), moments within
the JAX test's tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixed_draws
from bayesian_ode_tpu import samplers as jsamplers
from bayesian_ode_tpu_torch import samplers as tsamplers
from torch_parity import one_torch_thread  # noqa: F401

F64 = torch.float64
COV = np.asarray([[1.0, 0.6], [0.6, 0.8]])
PREC = np.linalg.inv(COV)


def wavy_t(p):
    """A non-convex 3-d potential (indefinite Hessians away from 0)."""
    x = p["x"]
    return (0.5 * (x ** 2).sum(-1) + 0.8 * torch.sin(2.0 * x[:, 0]) * x[:, 1]
            + 0.1 * x[:, 2] ** 4 - 0.3 * x[:, 1] * x[:, 2])


def wavy_j(p):
    x = p["x"]
    return (0.5 * jnp.sum(x ** 2) + 0.8 * jnp.sin(2.0 * x[0]) * x[1]
            + 0.1 * x[2] ** 4 - 0.3 * x[1] * x[2])


def convex_t(p):
    x = p["x"]
    return 0.5 * (x ** 2).sum(-1) + 0.05 * (x ** 4).sum(-1) + 0.2 * x[:, 0] \
        * x[:, 1]


def convex_j(p):
    x = p["x"]
    return 0.5 * jnp.sum(x ** 2) + 0.05 * jnp.sum(x ** 4) + 0.2 * x[0] * x[1]


def gauss_t(p):
    return 0.5 * torch.einsum("ci,ij,cj->c", p["x"], torch.tensor(PREC),
                              p["x"])


X = np.random.RandomState(0).randn(6, 3) * 1.2


def _close(a, b, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_flat_hessian_is_jax_hessian():
    H = tsamplers.flat_hessian(wavy_t, {"x": torch.tensor(X)})
    H_j = jax.vmap(lambda x: jsamplers.flat_hessian(wavy_j, {"x": x}))(
        jnp.asarray(X))
    _close(H, H_j)
    assert (np.linalg.eigvalsh(np.asarray(H_j)) < 0).any()   # indefinite


@pytest.mark.parametrize("coeff", [1.0, 1e3])
def test_softabs_metric_sign_invariant_products(coeff):
    got = tsamplers.softabs_metric(wavy_t, coeff)({"x": torch.tensor(X)})
    for c in range(X.shape[0]):
        want = jsamplers.softabs_metric(wavy_j, coeff)({"x": jnp.asarray(
            X[c])})
        for name in ("hess", "Metric", "invMetric", "log_det_sqrt"):
            _close(got[name][c], want[name])
        for name, like in (("sqrtinvMetric", "invMetric"),
                           ("sqrtMetric", "Metric")):
            S, S_j = got[name][c], np.asarray(want[name])
            _close(S @ S.T, S_j @ S_j.T)
            _close(S @ S.T, got[like][c])


def test_hessian_and_identity_metrics_match_jax():
    got = tsamplers.hessian_metric(convex_t)({"x": torch.tensor(X)})
    for c in range(X.shape[0]):
        want = jsamplers.hessian_metric(convex_j)({"x": jnp.asarray(X[c])})
        for name in ("Metric", "invMetric", "sqrtinvMetric"):
            _close(got[name][c], want[name])
    eye = tsamplers.identity_metric(3)({"x": torch.tensor(X)})
    assert eye["invMetric"].shape == (6, 3, 3)
    _close(eye["sqrtinvMetric"][2], np.asarray(
        jsamplers.identity_metric(3)(None)["sqrtinvMetric"]))


def _jax_chains(kernel, x, steps):
    states = jax.vmap(kernel.init)({"x": jnp.asarray(x)})
    keys = jax.random.split(jax.random.PRNGKey(0), x.shape[0])
    _, pos, infos = jsamplers.sample_chains(kernel, states, keys,
                                            num_samples=steps)
    return np.asarray(pos["x"]), np.asarray(infos["accepted"])


def test_mmala_drift_steps_match_jax(monkeypatch):
    """add_noise=False with zero proposal noise: the metric's drift, step
    after step, through the SoftAbs metric of a non-convex potential."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=float, *a, **k:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(torch, "randn",
                        lambda *size, generator=None, dtype=None,
                        device=None, **k: torch.zeros(*size, dtype=dtype,
                                                      device=device))
    lr = 0.05
    kern = tsamplers.mmala_batched(
        wavy_t, lr, tsamplers.softabs_metric(wavy_t, 2.0), add_noise=False)
    _, pos, _ = tsamplers.sample_chain(kern, kern.init({"x": torch.tensor(X)}),
                                       None, 5)
    want, _ = _jax_chains(jsamplers.mmala(
        wavy_j, lr, jsamplers.softabs_metric(wavy_j, 2.0), add_noise=False),
        X, 5)
    _close(pos["x"].transpose(0, 1), want)


def test_mmala_accept_reject_steps_match_jax(monkeypatch):
    """Noisy MMALA through the Hessian metric (unique Cholesky square
    root): proposals, Metropolis-Hastings ratios and accept flags equal
    the JAX package's per-chain kernel under vmap, chain by chain."""
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch, chain_constant=True)
    lr = 0.4
    kern = tsamplers.mmala_batched(convex_t, lr,
                                   tsamplers.hessian_metric(convex_t))
    _, pos, infos = tsamplers.sample_chain(
        kern, kern.init({"x": torch.tensor(X)}), None, 6)
    want, acc = _jax_chains(jsamplers.mmala(
        convex_j, lr, jsamplers.hessian_metric(convex_j)), X, 6)
    np.testing.assert_array_equal(infos["accepted"].T.numpy(), acc)
    assert acc.any() and not acc.all()
    _close(pos["x"].transpose(0, 1), want, rtol=1e-9)
    # the single-chain kernel is the batched one over a batch of one
    one = tsamplers.mmala(
        lambda p: convex_t({"x": p["x"][None]})[0], lr,
        lambda p: {k: v[0] for k, v in tsamplers.hessian_metric(convex_t)(
            {"x": p["x"][None]}).items()})
    _, pos1, _ = tsamplers.sample_chain(
        one, one.init({"x": torch.tensor(X[0])}), None, 6)
    _close(pos1["x"], want[0], rtol=1e-9)


def test_mmala_softabs_gaussian_moments():
    gen = torch.Generator().manual_seed(0)
    kern = tsamplers.mmala_batched(
        gauss_t, 0.5, tsamplers.softabs_metric(gauss_t, softabs_coeff=1e3))
    x0 = {"x": torch.randn((64, 2), generator=gen, dtype=F64)}
    _, pos, infos = tsamplers.sample_chain(kern, kern.init(x0), gen, 300,
                                           burn_in=100)
    assert float(infos["accepted"].float().mean()) > 0.3
    flat = pos["x"].reshape(-1, 2).numpy()
    assert np.max(np.abs(flat.mean(0))) < 0.15, flat.mean(0)
    assert np.max(np.abs(np.cov(flat.T) - COV)) < 0.25, np.cov(flat.T)
