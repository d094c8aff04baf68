"""Parity of the port's continuous adjoint (`ode/adjoint.py`) with the
JAX package's, in float64 on the CPU.

The cotangents of y0, t and the field's parameters from `odeint_adjoint`
are held to JAX `odeint_adjoint` within 1e-6 max-rel (BASELINE's "adjoint
matching ... to 1e-6") at rtol=1e-7/atol=1e-9; both take the same steps
in the forward and the backward solves, so they agree far closer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import odeint_adjoint as jadjoint
from bayesian_ode_tpu_torch.ode import odeint, odeint_adjoint
from bayesian_ode_tpu_torch.ode import adjoint as tadjoint
from torch_parity import max_rel, one_torch_thread  # noqa: F401

H = 8
RNG = np.random.RandomState(0)
PARAMS = (0.3 * RNG.randn(2, H), 0.1 * RNG.randn(H), 0.3 * RNG.randn(H, 2),
          0.1 * RNG.randn(2))
Y0 = np.array([[2.0, 0.0], [1.0, 0.5], [-0.8, 0.9]])
TS = np.linspace(0.0, 2.0, 8)
W = RNG.randn(8, 3, 2)
TOL = {"rtol": 1e-7, "atol": 1e-9}


def jfield(p):
    return lambda t, y: jnp.tanh((y ** 3) @ p[0] + p[1]) @ p[2] + p[3]


def tfield(p):
    return lambda t, y: torch.tanh((y ** 3) @ p[0] + p[1]) @ p[2] + p[3]


def jax_grads(ts, **kw):
    def loss(p, y0, t):
        return jnp.sum(jadjoint(jfield(p), y0, t, **TOL, **kw) * W)

    return jax.grad(loss, argnums=(0, 1, 2))(
        tuple(map(jnp.asarray, PARAMS)), jnp.asarray(Y0), jnp.asarray(ts))


def port_grads(ts, **kw):
    p = [torch.tensor(x, requires_grad=True) for x in PARAMS]
    y0 = torch.tensor(Y0, requires_grad=True)
    t = torch.tensor(ts, requires_grad=True)
    ys = odeint_adjoint(tfield(p), y0, t, adjoint_params=p, **TOL, **kw)
    (ys * torch.tensor(W)).sum().backward()
    return tuple(x.grad for x in p), y0.grad, t.grad


@pytest.mark.parametrize("kw,reverse", [
    ({}, False), ({}, True),
    ({"method": "dopri5", "adjoint_options": {"norm": "seminorm"}}, False),
    ({"method": "rk4"}, False), ({"method": "rk4"}, True),
    ({"method": "tsit5"}, False),
    ({"method": "dopri5", "adjoint_method": "tsit5",
      "adjoint_rtol": 1e-8}, False),
])
def test_adjoint_cotangents_match_jax(kw, reverse):
    ts = TS[::-1].copy() if reverse else TS
    (jp, jy0, jt) = jax_grads(ts, **kw)
    (tp, ty0, tt) = port_grads(ts, **kw)
    for a, b in zip(tp, jp):
        assert max_rel(a, b) <= 1e-6
    assert max_rel(ty0, jy0) <= 1e-6
    assert max_rel(tt, jt) <= 1e-6


def test_adjoint_agrees_with_autograd_through_the_solver():
    """The continuous adjoint and reverse mode through the step loop are
    two gradients of one solve: at rtol=1e-10 they agree to ~1e-7."""
    def grads(solve):
        p = [torch.tensor(x, requires_grad=True) for x in PARAMS]
        ys = solve(p)
        (ys * torch.tensor(W)).sum().backward()
        return [x.grad for x in p]

    tol = {"rtol": 1e-10, "atol": 1e-12}
    g_adj = grads(lambda p: odeint_adjoint(tfield(p), torch.tensor(Y0),
                                           torch.tensor(TS), **tol,
                                           adjoint_params=p))
    g_bp = grads(lambda p: odeint(tfield(p), torch.tensor(Y0),
                                  torch.tensor(TS), **tol))
    for a, b in zip(g_adj, g_bp):
        assert max_rel(a, b) <= 1e-6


def test_a_batch_of_chains_equals_the_chains_one_by_one():
    """4 chains with their own parameters (a leading chain axis), each with
    its own step sizes in the forward and the backward solve, against each
    chain solved alone."""
    C = 4
    rng = np.random.RandomState(7)
    P = [x[None] + 0.05 * rng.randn(C, *x.shape) for x in PARAMS]

    def bfield(p):
        def f(t, y):                        # y (C, 3, 2)
            h = torch.tanh(torch.matmul(y ** 3, p[0]) + p[1][:, None])
            return torch.matmul(h, p[2]) + p[3][:, None]
        return f

    p = [torch.tensor(x, requires_grad=True) for x in P]
    y0 = torch.tensor(np.broadcast_to(Y0, (C,) + Y0.shape).copy(),
                      requires_grad=True)
    tadjoint.nfe_counts.update(forward=0, backward=0)
    ys = odeint_adjoint(bfield(p), y0, torch.tensor(TS), **TOL,
                        adjoint_params=p, batched=True)
    assert ys.shape == (len(TS), C, 3, 2)
    (ys * torch.tensor(W)[:, None]).sum().backward()
    assert tadjoint.nfe_counts["forward"] > 0
    assert tadjoint.nfe_counts["backward"] > tadjoint.nfe_counts["forward"]
    for c in range(C):
        q = [torch.tensor(x[c], requires_grad=True) for x in P]
        yc = torch.tensor(Y0, requires_grad=True)
        ys_c = odeint_adjoint(tfield(q), yc, torch.tensor(TS), **TOL,
                              adjoint_params=q)
        torch.testing.assert_close(ys[:, c], ys_c.detach(), rtol=1e-12,
                                   atol=1e-12)
        (ys_c * torch.tensor(W)).sum().backward()
        for a, b in zip(p, q):
            torch.testing.assert_close(a.grad[c], b.grad, rtol=1e-10,
                                       atol=1e-12)
        torch.testing.assert_close(y0.grad[c], yc.grad, rtol=1e-10,
                                   atol=1e-12)


def test_module_parameters_are_the_default():
    class Field(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.p = torch.nn.ParameterList(
                [torch.nn.Parameter(torch.tensor(x)) for x in PARAMS])

        def forward(self, t, y):
            return tfield(self.p)(t, y)

    f = Field()
    ys = odeint_adjoint(f, torch.tensor(Y0), torch.tensor(TS), **TOL)
    (ys * torch.tensor(W)).sum().backward()
    (jp, _, _) = jax_grads(TS)
    for a, b in zip(f.p, jp):
        assert max_rel(a.grad, b) <= 1e-6


def test_adjoint_raises():
    p = [torch.tensor(x, requires_grad=True) for x in PARAMS]
    y0, t = torch.tensor(Y0), torch.tensor(TS)
    with pytest.raises(ValueError, match="leading system axis"):
        odeint_adjoint(tfield(p), y0[None].repeat(2, 1, 1), t,
                       adjoint_params=p, batched=True)
    with pytest.raises(ValueError, match="without specifying"):
        odeint_adjoint(tfield(p), y0, t, options={"safety": 0.8})
    # complex states: the adjoint of the view-as-real solve
    z0 = torch.tensor([1.0 + 0.5j, -0.3 + 0.2j], dtype=torch.complex128,
                      requires_grad=True)
    zs = odeint_adjoint(lambda t, y: (1j - 0.1) * y, z0, t)
    assert zs.dtype == torch.complex128 and zs.shape == (len(TS), 2)
    zs.abs().pow(2).sum().backward()
    # |z(t)|^2 = exp(-0.2 t) |z0|^2, so d/d z0 = 2 z0 sum_t exp(-0.2 t)
    want = 2 * z0.detach() * np.exp(-0.2 * TS).sum()
    torch.testing.assert_close(z0.grad, want, rtol=1e-6, atol=0)
    # adams, forward and adjoint, against the JAX adjoint's gradients
    ys = odeint_adjoint(tfield(p), y0, t, method="adams", adjoint_params=p,
                        **TOL)
    (ys * torch.tensor(W)).sum().backward()
    (jp, _, _) = jax_grads(TS, method="adams")
    for a, b in zip(p, jp):
        assert max_rel(a.grad, b) <= 1e-5
    ys = odeint_adjoint(tfield(p), y0, t, adjoint_params=p,
                        adjoint_options={"norm": "l2"})
    with pytest.raises(ValueError, match="unknown adjoint norm"):
        ys.sum().backward()


@pytest.mark.parametrize("method", ["adams", "bosh3", "dopri8", "sdirk4",
                                    "fixed_adams"])
def test_second_order_raises_at_looped_methods(method):
    """A create_graph backward differentiates the backward solve: at a
    method with an accept/reject loop (or fixed_adams' corrector loop) it
    raises, as the JAX package's reverse pass through a while loop does;
    the driver refuses Laplace there before any solve."""
    from bayesian_ode_tpu_torch.experiments import vanderpol_gp as vg

    p = torch.tensor([0.7], dtype=torch.float64, requires_grad=True)
    ys = odeint_adjoint(lambda t, y: -p * y, torch.ones(1,
                        dtype=torch.float64), torch.tensor([0.0, 0.5, 1.0]),
                        method=method, adjoint_params=(p,))
    with pytest.raises(ValueError, match="fixed-grid adjoint method"):
        torch.autograd.grad(ys.sum(), p, create_graph=True)
    with pytest.raises(ValueError, match="fixed-grid solver"):
        vg._check_second_order({"solver": method}, "method='Laplace'")
