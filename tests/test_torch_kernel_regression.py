"""Parity of the port's GP kernel-regression model with the JAX package, in
float64 to 1e-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.models import kernel_regression as jkr
from bayesian_ode_tpu.models import make_dataset
from bayesian_ode_tpu_torch.models import kernel_regression as tkr

TOL = 1e-10        # float64, same formulas: rounding-level agreement


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.max(np.abs(b))), 1e-300)
    assert float(np.max(np.abs(a - b))) <= tol * scale


@pytest.fixture(scope="module")
def problem():
    data = make_dataset(jax.random.PRNGKey(3), "vdp", N=5, T=12, t_max=2.5,
                        noise=0.05, x0_scale=1.5)
    Y = np.asarray(data["Y"])
    t = np.asarray(data["t"])
    Z = jkr.make_inducing_grid(Y, M=6)
    static = jkr.make_static(Z, sf=1.0, ell=0.75)
    tZ = tkr.make_inducing_grid(torch.tensor(Y), M=6)
    tstatic = tkr.make_static(tZ, sf=1.0, ell=0.75)
    return data, Y, t, static, tstatic


def test_rbf_matches_jax():
    rng = np.random.RandomState(0)
    X1, X2 = rng.randn(3, 7, 2), rng.randn(36, 2)
    for sf, ell in ((1.0, 0.75), (1.7, 0.3)):
        _close(tkr.rbf(torch.tensor(X1), torch.tensor(X2), sf, ell),
               jkr.rbf(jnp.asarray(X1), jnp.asarray(X2), sf, ell))


def test_grid_and_static_match_jax(problem):
    _, _, _, static, tstatic = problem
    _close(tstatic.Z, static.Z, 0.0)
    _close(tstatic.KzzinvL, static.KzzinvL)
    _close(tstatic.Kzzinv, static.Kzzinv)
    assert (tstatic.sf, tstatic.ell) == (static.sf, static.ell)


def test_init_params_match_jax(problem):
    _, Y, t, static, tstatic = problem
    p = jkr.init_params(Y, t, static, noise=0.05)
    tp = tkr.init_params(torch.tensor(Y), torch.tensor(t), tstatic,
                         noise=0.05)
    _close(tp["U"], p["U"])
    _close(tp["logsn"], p["logsn"])


def test_vector_fields_match_jax(problem):
    _, Y, t, static, tstatic = problem
    p = jkr.init_params(Y, t, static, noise=0.05)
    tp = tkr.params_from_numpy(p)
    X = np.random.RandomState(1).randn(5, 2)
    A = jkr.precompute_weights(p, static)
    tA = tkr.precompute_weights(tp, tstatic)
    _close(tA, A)
    _close(tkr.vector_field_fast(tA, tstatic, 0.0, torch.tensor(X)),
           jkr.vector_field_fast(A, static, 0.0, jnp.asarray(X)))
    _close(tkr.vector_field(tp, tstatic, 0.0, torch.tensor(X)),
           jkr.vector_field(p, static, 0.0, jnp.asarray(X)))


def _euler(np_mod):
    """An explicit Euler integrator with identical arithmetic in both
    frameworks, so the potential's own formula is what is compared."""
    def solve(f, x0, t):
        ys, y = [x0], x0
        for i in range(len(t) - 1):
            y = y + (t[i + 1] - t[i]) * f(t[i], y)
            ys.append(y)
        return np_mod.stack(ys)
    return solve


@pytest.mark.parametrize("add_prior", [True, False])
def test_make_potential_matches_jax(problem, add_prior):
    data, Y, t, static, tstatic = problem
    x0 = np.asarray(data["x0"])
    p = jkr.init_params(Y, t, static, noise=0.05)
    p = {"U": p["U"] + 0.01, "logsn": p["logsn"] + 0.1}
    pot = jkr.make_potential(static, jnp.asarray(x0), jnp.asarray(t),
                             jnp.asarray(Y), _euler(jnp),
                             add_prior=add_prior)
    tpot = tkr.make_potential(tstatic, torch.tensor(x0), torch.tensor(t),
                              torch.tensor(Y), _euler(torch),
                              add_prior=add_prior)
    _close(tpot(tkr.params_from_numpy(p)), pot(p))
    g = jax.grad(pot)(p)
    tp = {k: v.requires_grad_(True)
          for k, v in tkr.params_from_numpy(p).items()}
    tpot(tp).backward()
    _close(tp["U"].grad, g["U"])
    if add_prior:
        _close(tp["logsn"].grad, g["logsn"])
    else:
        assert tp["logsn"].grad is None and not np.any(np.asarray(g["logsn"]))


def test_numpy_converters_round_trip(problem):
    _, Y, t, static, _ = problem
    ts = tkr.static_from_numpy(static.Z, static.KzzinvL, static.Kzzinv,
                               static.sf, static.ell)
    for a, b in zip(ts[:3], static[:3]):
        assert ts.Z.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ts32 = tkr.static_from_numpy(static.Z, static.KzzinvL, static.Kzzinv,
                                 static.sf, static.ell, dtype=torch.float32)
    np.testing.assert_array_equal(ts32.Z.numpy(),
                                  np.asarray(static.Z, np.float32))
    p = jkr.init_params(Y, t, static, noise=0.05)
    tp = tkr.params_from_numpy(p)
    assert sorted(tp) == sorted(p)
    for k in p:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(p[k]))


def test_full_f32_matmul_turns_tf32_off():
    tkr.full_f32_matmul()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
