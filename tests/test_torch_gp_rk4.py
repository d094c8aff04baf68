"""Parity of the port's fused rk4 GP engine (plain versions of kernels K4
and K5) with the JAX package's Pallas kernels run in interpret mode.

Gates.  Trajectories in float32 to 1e-5 * max|y|: both sides take the
same 3/8-rule steps on the same grid and differ by the order of the sum
over the inducing points and by exp's rounding (measured 2.3e-6 at
max|y| 3.28 over 60 steps).  Cotangents to 1e-5 max-rel against jax.vjp
of the kernel (measured 5.7e-7).  The plain backward against autograd
through the plain forward in float64 to 1e-10: the same arithmetic
differentiated two ways.  Potentials, value and gradient, to 1e-5
relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ops.gp_rk4 import gp_rk4_trajectory as jtrajectory
from bayesian_ode_tpu.ops.gp_rk4 import (
    make_fused_gp_potential as jmake_potential,
)
from bayesian_ode_tpu_torch.ops import gp_rk4 as tg
from torch_parity import (  # noqa: F401
    gp_problem,
    max_rel,
    one_torch_thread,
    to_np,
)


@pytest.fixture(scope="module")
def problem():
    return gp_problem(C=128)


@pytest.fixture(scope="module")
def jax_vjp(problem):
    """The JAX kernel's trajectories and their vjp for a seeded cotangent."""
    p = problem
    ts = jnp.asarray(p["t"])

    def traj(A, x0):
        return jtrajectory(A, x0, ts, p["jstatic32"], tile=128,
                           interpret=True)

    ys, vjp = jax.vjp(traj, jnp.asarray(p["A"]), jnp.asarray(p["x0"]))
    g = np.random.RandomState(5).randn(*ys.shape).astype(np.float32)
    Abar, x0bar = vjp(jnp.asarray(g))
    return np.asarray(ys), g, np.asarray(Abar), np.asarray(x0bar)


def _tensors(p, dtype=torch.float32):
    s = p["tstatic"]
    return (torch.tensor(p["A"], dtype=dtype), s.Z.to(dtype),
            torch.tensor(p["x0"], dtype=dtype),
            torch.diff(torch.tensor(p["t"], dtype=torch.float32)).to(dtype),
            s.sf, s.ell)


def test_plain_forward_matches_the_jax_kernel(problem, jax_vjp):
    A, Z, x0, dts, sf, ell = _tensors(problem)
    ys = tg.gp_rk4_fwd_plain(A, Z, x0, dts, sf, ell)
    ys_j = jax_vjp[0]
    assert ys.dtype == torch.float32 and tuple(ys.shape) == ys_j.shape
    assert np.max(np.abs(to_np(ys) - ys_j)) <= 1e-5 * np.max(np.abs(ys_j))
    torch.testing.assert_close(ys[0], x0.expand(128, 5, 2), rtol=0, atol=0)


def test_plain_backward_matches_the_jax_vjp(problem, jax_vjp):
    A, Z, x0, dts, sf, ell = _tensors(problem)
    ys = tg.gp_rk4_fwd_plain(A, Z, x0, dts, sf, ell)
    _, g, Abar_j, x0bar_j = jax_vjp
    Abar, lbar = tg.gp_rk4_bwd_plain(A, Z, ys, torch.tensor(g), dts, sf, ell)
    assert Abar.shape == A.shape and lbar.shape == (128, 5, 2)
    assert max_rel(Abar, Abar_j) <= 1e-5
    assert max_rel(lbar.sum(dim=0), x0bar_j) <= 1e-5


def test_plain_backward_is_the_gradient_of_the_plain_forward_f64(problem):
    A, Z, x0, dts, sf, ell = _tensors(problem, torch.float64)
    A, x0 = A[:16], x0
    ys = tg.gp_rk4_fwd_plain(A, Z, x0, dts, sf, ell)
    g = torch.tensor(np.random.RandomState(6).randn(*ys.shape))
    Abar, lbar = tg.gp_rk4_bwd_plain(A, Z, ys, g, dts, sf, ell)
    Ar, xr = A.clone().requires_grad_(True), x0.clone().requires_grad_(True)
    ga, gx = torch.autograd.grad(
        (tg.gp_rk4_fwd_plain(Ar, Z, xr, dts, sf, ell) * g).sum(), [Ar, xr])
    assert max_rel(Abar, ga) <= 1e-10
    assert max_rel(lbar.sum(dim=0), gx) <= 1e-10


def test_trajectory_autograd_function_on_the_cpu(problem):
    """gp_rk4_trajectory takes the plain versions for CPU tensors, and its
    gradient is the plain backward's."""
    p = problem
    A = torch.tensor(p["A"][:8]).requires_grad_(True)
    x0 = torch.tensor(p["x0"]).requires_grad_(True)
    ys = tg.gp_rk4_trajectory(A, x0, torch.tensor(p["t"]), p["tstatic"])
    g = torch.tensor(np.random.RandomState(7).randn(*ys.shape),
                     dtype=torch.float32)
    (ys * g).sum().backward()
    A2, Z, x02, dts, sf, ell = _tensors(p)
    Abar, lbar = tg.gp_rk4_bwd_plain(A2[:8], Z, ys.detach(), g, dts, sf, ell)
    torch.testing.assert_close(A.grad, Abar, rtol=0, atol=0)
    torch.testing.assert_close(x0.grad, lbar.sum(dim=0), rtol=0, atol=0)


def test_fused_potential_matches_jax(problem):
    p = problem
    jpot = jmake_potential(p["jstatic32"], jnp.asarray(p["x0"]),
                           jnp.asarray(p["t"]), jnp.asarray(p["Y"]),
                           tile=128, interpret=True)
    jparams = {"U": jnp.asarray(p["U"]), "logsn": jnp.asarray(p["logsn"])}
    jval, vjp = jax.vjp(jpot, jparams)
    (jgrad,) = vjp(jnp.ones_like(jval))

    tpot = tg.make_fused_gp_potential(p["tstatic"], torch.tensor(p["x0"]),
                                      torch.tensor(p["t"]),
                                      torch.tensor(p["Y"]))
    tparams = {k: torch.tensor(p[k]).requires_grad_(True)
               for k in ("U", "logsn")}
    tval = tpot(tparams)
    tval.sum().backward()
    assert tval.shape == (128,) and tval.dtype == torch.float32
    np.testing.assert_allclose(to_np(tval), np.asarray(jval), rtol=1e-5)
    for k in ("U", "logsn"):
        assert max_rel(tparams[k].grad, jgrad[k]) <= 1e-5, k
