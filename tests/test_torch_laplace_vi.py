"""The Laplace approximation, the port's second-order derivative through the
continuous adjoint, and ADVI, against the JAX package in float64 on the
CPU.

Gates.  Laplace on a quadratic potential gives the closed-form log Z (to
1e-6: the relative 1e-8 ridge) and the JAX package's fit to 1e-10.  The
GP posterior's Hessian at rk4 through `odeint_adjoint` (one double
backward over a D-row batch) equals the JAX package's jacrev of grad
through its custom_vjp to 1e-8 relative, asymmetry included (neither is
the Hessian of the discrete solve: the continuous adjoint's gradient is
not the solve's exact gradient).  At dopri5 both packages raise
ValueError.  ADVI (mean-field, full-rank, and with the sticking-the-
landing estimator) step for step with fixed draws, its draws and log q,
to 1e-9 relative.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixed_draws
from bayesian_ode_tpu import samplers as jsamplers
from bayesian_ode_tpu.experiments import vanderpol_gp as jvg
from bayesian_ode_tpu.utils.pytree import ravel_pytree as jravel
from bayesian_ode_tpu_torch import samplers as tsamplers
from bayesian_ode_tpu_torch.experiments import vanderpol_gp as vg
from torch_parity import (  # noqa: F401
    GENERIC_CONFIG,
    generic_data,
    one_torch_thread,
)

F64 = torch.float64
tvi = importlib.import_module("bayesian_ode_tpu_torch.samplers.vi")

# a quadratic potential 0.5 (x - m)^T A (x - m) + c over {"a": (2,), "b": ()}
_R = np.random.RandomState(0).randn(3, 3)
A_Q = _R @ _R.T + 3.0 * np.eye(3)
M_Q, C_Q = np.asarray([0.3, -1.2, 0.7]), 2.5


def quad_batch(p):
    x = torch.cat([p["a"], p["b"][:, None]], dim=1) - torch.tensor(M_Q)
    return 0.5 * torch.einsum("ci,ij,cj->c", x, torch.tensor(A_Q), x) + C_Q


def quad_j(p):
    x = jnp.concatenate([p["a"], p["b"][None]]) - M_Q
    return 0.5 * x @ A_Q @ x + C_Q


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_laplace_quadratic_exact_and_as_jax(monkeypatch):
    x0 = {"a": np.asarray([1.0, 1.0]), "b": np.asarray(-0.5)}
    got = tsamplers.laplace_approximation(
        quad_batch, {k: torch.tensor(v) for k, v in x0.items()}, 20)
    want = jsamplers.laplace_approximation(
        quad_j, {k: jnp.asarray(v) for k, v in x0.items()}, 20)
    exact = -C_Q + 1.5 * math.log(2 * math.pi) \
        - 0.5 * np.linalg.slogdet(A_Q)[1]
    assert bool(got.hessian_pd)
    assert abs(float(got.log_evidence) - exact) < 1e-6
    _close(got.mu, M_Q, 0.0, atol=1e-8)
    for name in ("mu", "prec_chol", "log_evidence", "potential_at_mode",
                 "value_trace"):
        _close(getattr(got, name), getattr(want, name), 1e-10, atol=1e-12)
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch)
    d_t = tsamplers.sample_laplace(got, None, 6)
    d_j = jsamplers.sample_laplace(want, jax.random.PRNGKey(0), 6)
    for k in d_t:
        _close(d_t[k], d_j[k], 1e-10)
    assert d_t["a"].shape == (6, 2) and d_t["b"].shape == (6,)


def test_laplace_flags_a_saddle_as_jax():
    def saddle_t(p):
        return 0.5 * (p["x"][:, 0] ** 2 - p["x"][:, 1] ** 2)

    def saddle_j(p):
        return 0.5 * (p["x"][0] ** 2 - p["x"][1] ** 2)

    got = tsamplers.laplace_approximation(
        saddle_t, {"x": torch.zeros(2, dtype=F64)}, 3)
    want = jsamplers.laplace_approximation(saddle_j,
                                           {"x": jnp.zeros(2)}, 3)
    assert not bool(got.hessian_pd) and not bool(want.hessian_pd)
    assert np.isnan(float(got.log_evidence)) and np.isnan(
        float(want.log_evidence))


@pytest.fixture(scope="module")
def gp():
    data = generic_data()
    out = {}
    for solver in ("rk4", "dopri5"):
        cfg = dict(GENERIC_CONFIG, M=3, solver=solver)
        static, p0 = vg.build_model(cfg, data)
        _, jp0, jpot, _ = jvg.build_model(cfg, data)
        out[solver] = (vg.make_generic_potential(cfg, data, static, "cpu",
                                                 F64), p0, jpot, jp0)
    return out


def test_gp_rk4_hessian_is_jax_jacrev_of_grad(gp):
    pot, p0, jpot, jp0 = gp["rk4"]
    rows = []

    def counted(p):
        rows.append(int(p["U"].shape[0]))
        return pot(p)

    H = tsamplers.flat_hessian(counted, {k: v[None] for k, v in
                                         p0.items()})[0].numpy()
    v, unravel = jravel(jp0)
    H_j = np.asarray(jax.jacrev(jax.grad(lambda x: jpot(unravel(x))))(v))
    assert rows == [20]                # one batch of D = 20 rows
    assert np.max(np.abs(H - H_j)) <= 1e-8 * np.max(np.abs(H_j))
    asym = np.max(np.abs(H - H.T)) / np.max(np.abs(H))
    assert 0 < asym < 1e-3
    # and the Laplace fit from the gradient-matched start, as the JAX one
    got = tsamplers.laplace_approximation(pot, p0, 4)
    want = jsamplers.laplace_approximation(jpot, jp0, 4)
    for name in ("mu", "potential_at_mode", "value_trace"):
        _close(getattr(got, name), getattr(want, name), 1e-10)
    H_got = got.prec_chol @ got.prec_chol.T
    H_want = np.asarray(want.prec_chol @ want.prec_chol.T)
    assert bool(got.hessian_pd) == bool(want.hessian_pd)
    if bool(want.hessian_pd):
        _close(H_got, H_want, 0.0, atol=1e-8 * np.max(np.abs(H_want)))
        _close(got.log_evidence, want.log_evidence, 1e-8)


def test_second_order_through_adaptive_solves_raises_in_both(gp):
    pot, p0, jpot, jp0 = gp["dopri5"]
    with pytest.raises(ValueError, match="fixed-grid adjoint method"):
        tsamplers.flat_hessian(pot, {k: v[None] for k, v in p0.items()})
    v, unravel = jravel(jp0)
    with pytest.raises(ValueError, match="lax.while_loop"):
        jax.jacrev(jax.grad(lambda x: jpot(unravel(x))))(v)


# ADVI on a banana-shaped posterior over {"a": (2,), "b": ()}
def banana_batch(p):
    a, b = p["a"], p["b"]
    return (0.5 * a[:, 0] ** 2 + 2.0 * (a[:, 1] - a[:, 0] ** 2) ** 2
            + 0.5 * (b - 0.3) ** 2 / 0.25)


def banana_j(p):
    a, b = p["a"], p["b"]
    return (0.5 * a[0] ** 2 + 2.0 * (a[1] - a[0] ** 2) ** 2
            + 0.5 * (b - 0.3) ** 2 / 0.25)


@pytest.mark.parametrize("family,stl", [("meanfield", False),
                                        ("fullrank", False),
                                        ("meanfield", True),
                                        ("fullrank", True)])
def test_advi_step_for_step(family, stl, monkeypatch):
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch)
    x0 = {"a": np.asarray([0.4, -0.2]), "b": np.asarray(0.1)}
    kw = dict(num_steps=25, sample_size=4, family=family,
              learning_rate=5e-2, init_scale=0.3, stl=stl)
    got = tsamplers.fit_advi(None, None, {k: torch.tensor(v) for k, v in
                                          x0.items()},
                             potential_batch=banana_batch, **kw)
    want = jsamplers.fit_advi(jax.random.PRNGKey(0), banana_j,
                              {k: jnp.asarray(v) for k, v in x0.items()},
                              **kw)
    for name in ("mu", "scale_tril", "elbo_trace", "final_elbo"):
        _close(getattr(got, name), getattr(want, name), 1e-9, atol=1e-12)
    # the scalar-potential path takes the same steps
    alone = tsamplers.fit_advi(
        None, lambda p: banana_batch({k: v[None] for k, v in p.items()})[0],
        {k: torch.tensor(v) for k, v in x0.items()}, **kw)
    _close(alone.mu, got.mu, 1e-12)
    d_t = tsamplers.sample_advi(got, None, 5)
    d_j = jsamplers.sample_advi(want, jax.random.PRNGKey(1), 5)
    for k in d_t:
        _close(d_t[k], d_j[k], 1e-9, atol=1e-12)
    probe = {"a": torch.tensor([0.1, 0.2], dtype=F64),
             "b": torch.tensor(0.05, dtype=F64)}
    _close(tsamplers.advi_log_prob(got, probe),
           jsamplers.advi_log_prob(want, {k: jnp.asarray(v.numpy())
                                          for k, v in probe.items()}), 1e-9)


def test_advi_argument_checks():
    x0 = {"a": torch.zeros(2, dtype=F64), "b": torch.zeros((), dtype=F64)}
    with pytest.raises(ValueError, match="family"):
        tsamplers.fit_advi(None, None, x0, 1, family="diag",
                           potential_batch=banana_batch)
    with pytest.raises(ValueError, match="potential"):
        tsamplers.fit_advi(None, None, x0, 1)
    L = tvi._unpack_scale("fullrank", torch.arange(6.0, dtype=F64), 3)
    assert torch.equal(torch.diagonal(L), torch.exp(torch.tensor(
        [0.0, 2.0, 5.0], dtype=F64)))
