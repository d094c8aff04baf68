"""The port's Euler-Maruyama pseudo-likelihood potentials
(`sde.inference`: `em_log_likelihood`, `make_sde_potential`,
`make_gp_sde_potential`, `make_gp_sde_potential_batched`) against the JAX
package's, on the CPU.

Gates.  The batched NPSDE potential over a chain batch and its gradient:
within 1e-12 (float64) and 1e-5 (float32) of the JAX package's, relative
to the largest entry; it also equals the port's per-chain
`make_gp_sde_potential` chain by chain (1e-12 in float64), as the JAX
package's batched form equals its vmap of the per-chain one
(tests/test_sde.py).  The per-chain potentials and the EM likelihood of a
tree state: within 1e-12 of JAX's, gradients too.  The OU conjugate
posterior: the potential's curvature (a double backward) and its Newton
minimizer equal the closed form to 1e-9, as in the JAX package's test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import sde as jsde
from bayesian_ode_tpu.models import kernel_regression as jkr
from bayesian_ode_tpu_torch import sde as tsde
from bayesian_ode_tpu_torch.models import kernel_regression as tkr
from torch_parity import max_rel, one_torch_thread, to_np  # noqa: F401

F64 = torch.float64
TS = np.linspace(0.0, 3.0, 31)
C = 5


@pytest.fixture(scope="module")
def problem():
    """2-D linear-SDE replicate data (R=6, T=31) by the JAX sdeint, a 4x4
    inducing grid, and C=5 chains of {"U", "logsd"}."""
    rng = np.random.RandomState(31)
    A = np.array([[-0.4, 0.9], [-0.9, -0.4]])
    n = (len(TS) - 1) * 4
    dW = rng.randn(n, 6, 2) * np.sqrt(0.1 / 4)
    ys = jsde.sdeint(lambda t, y: y @ A.T, lambda t, y: jnp.full_like(y, 0.2),
                     jnp.asarray(rng.randn(6, 2)), TS, None,
                     options={"substeps": 4, "dW": jnp.asarray(dW)})
    Y = np.asarray(jnp.moveaxis(ys, 0, 1))
    static = jkr.make_static(jkr.make_inducing_grid(Y, M=4), sf=1.0, ell=1.0)
    params = {"U": 0.3 * rng.randn(C, 16, 2), "logsd": 0.2 * rng.randn(C, 2)}
    return Y, static, params


def _tstatic(static, dtype=F64):
    return tkr.static_from_numpy(static.Z, static.KzzinvL, static.Kzzinv,
                                 static.sf, static.ell, dtype=dtype)


def _tparams(params, dtype=F64):
    return {k: torch.tensor(v, dtype=dtype, requires_grad=True)
            for k, v in params.items()}


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_batched_potential_and_gradient_match_jax(problem, dtype, tol):
    Y, static, params = problem
    jt = jnp.dtype(dtype)
    jstatic = static._replace(Z=static.Z.astype(jt),
                              KzzinvL=static.KzzinvL.astype(jt),
                              Kzzinv=static.Kzzinv.astype(jt))
    pot_j = jsde.make_gp_sde_potential_batched(
        jstatic, TS.astype(dtype), Y.astype(dtype),
        precision=jax.lax.Precision.HIGHEST)
    jp = {k: jnp.asarray(v, jt) for k, v in params.items()}
    want, gwant = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(pot_j(p))))(jp)
    want_vec = jax.jit(pot_j)(jp)

    tdt = torch.float64 if dtype == np.float64 else torch.float32
    pot = tsde.make_gp_sde_potential_batched(
        _tstatic(static, tdt), TS.astype(dtype), Y.astype(dtype),
        precision="highest")
    p = _tparams(params, tdt)
    got = pot(p)
    assert got.shape == (C,) and got.dtype == tdt
    grads = torch.autograd.grad(got.sum(), [p["U"], p["logsd"]])
    assert max_rel(got, want_vec) <= tol
    assert max_rel(grads[0], gwant["U"]) <= tol
    assert max_rel(grads[1], gwant["logsd"]) <= tol


def test_batched_potential_equals_the_per_chain_one(problem):
    Y, static, params = problem
    ts_static = _tstatic(static)
    pot_b = tsde.make_gp_sde_potential_batched(ts_static, TS, Y)
    pot_1 = tsde.make_gp_sde_potential(ts_static, TS, Y)
    p = _tparams(params)
    got = pot_b(p)
    g_b = torch.autograd.grad(got.sum(), [p["U"], p["logsd"]])
    for c in range(C):
        pc = {k: v[c].detach().clone().requires_grad_(True)
              for k, v in p.items()}
        u = pot_1(pc)
        g_1 = torch.autograd.grad(u, [pc["U"], pc["logsd"]])
        assert abs(float(u - got[c])) <= 1e-12 * abs(float(u))
        for a, b in zip(g_b, g_1):
            assert max_rel(a[c], b) <= 1e-12


def test_per_chain_potential_matches_jax(problem):
    Y, static, params = problem
    for add_prior in (True, False):
        pot_j = jsde.make_gp_sde_potential(static, TS, Y, add_prior=add_prior)
        pot = tsde.make_gp_sde_potential(_tstatic(static), TS, Y,
                                         add_prior=add_prior)
        jp = {k: jnp.asarray(v[1]) for k, v in params.items()}
        want, gwant = jax.jit(jax.value_and_grad(pot_j))(jp)
        p = {k: torch.tensor(v[1], requires_grad=True)
             for k, v in params.items()}
        got = pot(p)
        g = torch.autograd.grad(got, [p["U"], p["logsd"]])
        assert abs(float(got) - float(want)) <= 1e-12 * abs(float(want))
        assert max_rel(g[0], gwant["U"]) <= 1e-12
        assert max_rel(g[1], gwant["logsd"]) <= 1e-12


def test_em_log_likelihood_of_a_tree_matches_jax():
    rng = np.random.RandomState(4)
    ts = np.linspace(0.0, 2.0, 11)
    Y = {"a": rng.randn(11, 3), "b": rng.randn(11, 2, 2)}

    def fields(lib):
        exp = jnp.exp if lib is jnp else torch.exp

        def drift(t, y):
            return {"a": -0.5 * y["a"] + t, "b": y["b"] ** 2 * 0.1}

        def diffusion(t, y):
            return {"a": 0.3 + 0.0 * y["a"], "b": exp(0.1 * y["b"])}

        return drift, diffusion

    want = jsde.em_log_likelihood(*fields(jnp), ts,
                                  jax.tree.map(jnp.asarray, Y))
    got = tsde.em_log_likelihood(*fields(torch), torch.tensor(ts),
                                 {k: torch.tensor(v) for k, v in Y.items()})
    assert abs(float(got) - float(want)) <= 1e-12 * abs(float(want))


def test_ou_conjugate_posterior_closed_form():
    # the EM pseudo-likelihood of dy = -theta y dt + sigma dW is quadratic
    # in theta: with a N(0, tau^2) prior the potential's curvature and
    # Newton minimizer are the closed-form posterior precision and mean
    sigma, tau = 0.5, 2.0
    ts = np.linspace(0.0, 4.0, 161)
    Y = tsde.sdeint(lambda t, y: -0.8 * y,
                    lambda t, y: torch.full_like(y, sigma),
                    torch.full((32,), 2.0, dtype=F64), ts,
                    torch.Generator().manual_seed(11),
                    options={"substeps": 20})                  # (T, R)
    pot = tsde.make_sde_potential(
        lambda th: (lambda t, y: -th * y),
        lambda th: (lambda t, y: torch.full_like(y, sigma)),
        torch.tensor(ts), Y, log_prior=lambda th: -0.5 * th ** 2 / tau ** 2)
    dt = float(ts[1] - ts[0])
    Yn = Y.numpy()
    P = (Yn[:-1] ** 2).sum() * dt / sigma ** 2 + 1.0 / tau ** 2
    mean = -(Yn[:-1] * (Yn[1:] - Yn[:-1])).sum() / sigma ** 2 / P

    th = torch.tensor(0.3, dtype=F64, requires_grad=True)
    g, = torch.autograd.grad(pot(th), th, create_graph=True)
    h, = torch.autograd.grad(g, th)
    np.testing.assert_allclose(float(h), P, rtol=1e-9)
    np.testing.assert_allclose(float(th - g / h), mean, rtol=1e-9, atol=1e-12)
    assert abs(float(th - g / h) - 0.8) < 0.1
    # the same potential in the JAX package on the same path
    pot_j = jsde.make_sde_potential(
        lambda th: (lambda t, y: -th * y),
        lambda th: (lambda t, y: jnp.full_like(y, sigma)),
        ts, jnp.asarray(Yn), log_prior=lambda th: -0.5 * th ** 2 / tau ** 2)
    want = float(pot_j(jnp.asarray(0.3)))
    assert abs(float(pot(th)) - want) <= 1e-12 * abs(want)


def test_exports():
    import bayesian_ode_tpu_torch as port

    assert port.sde.sdeint is port.sdeint
    assert port.sde.sdeint_adjoint is port.sdeint_adjoint
    assert sorted(port.sde.SDE_METHODS) == sorted(jsde.SDE_METHODS)
    assert sorted(port.sde.__all__) == sorted(jsde.__all__)
    assert to_np(torch.ones(1)).shape == (1,)
