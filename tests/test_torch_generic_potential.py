"""Parity of the generic engine's batch potential
(`experiments.vanderpol_gp.make_generic_potential`: the batched
`odeint_adjoint` under each model's own per-chain `make_potential`) with
the JAX driver's `vmap(value_and_grad(potential))` of `build_model`'s
per-chain potential, in float64 on the CPU.

The GP and MLP models here (the spiral and FitzHugh-Nagumo models in
`test_torch_generic_fields.py`), each held by
`torch_parity.check_generic_potential`: 4 chains with different
parameters, values to 1e-9 relative, gradients within 1e-6 max-rel.
"""
import numpy as np
import pytest
import torch

from bayesian_ode_tpu_torch.experiments import vanderpol_gp as tv
from bayesian_ode_tpu_torch.models import kernel_regression as tkr
from bayesian_ode_tpu_torch.samplers import batch_value_and_grad
from bayesian_ode_tpu_torch.utils.pytree import tree_leaves
from torch_parity import (  # noqa: F401
    GENERIC_CONFIG,
    check_generic_potential,
    generic_data,
    one_torch_thread,
    tree_max_rel,
)

C = 4


@pytest.fixture(scope="module")
def data():
    return generic_data()


@pytest.mark.parametrize("model,solver", [
    ("gp", "dopri5"), ("gp", "tsit5"), ("gp", "rk4"),
    ("nn", "dopri5"), ("nn", "rk4"),
])
def test_batch_potential_matches_jax_per_chain(data, model, solver):
    check_generic_potential(data, model, solver)


def test_batch_potential_equals_the_per_chain_definition(data):
    """Chain by chain, the batch potential is the model's own
    make_potential over the port's one-system odeint_adjoint."""
    from bayesian_ode_tpu_torch.ode import odeint_adjoint

    cfg = dict(GENERIC_CONFIG, model="gp", solver="dopri5")
    static, params0 = tv.build_model(cfg, data)
    rng = np.random.RandomState(5)
    P = {k: v[None] + 0.02 * torch.tensor(rng.randn(C, *v.shape))
         for k, v in params0.items()}
    u, g = batch_value_and_grad(
        tv.make_generic_potential(cfg, data, static, "cpu", torch.float64))(P)
    for c in range(C):
        p = {k: v[c].clone().requires_grad_(True) for k, v in P.items()}
        A = tkr.precompute_weights(p, static)

        def solve(f, x0, t):
            return odeint_adjoint(f, x0, t, method="dopri5", rtol=1e-7,
                                  atol=1e-9, adjoint_params=(A,))

        # the per-chain potential recomputes A from p inside; the adjoint
        # differentiates the A it closes over, which is this same product
        pot = tkr.make_potential(
            static, torch.tensor(data["x0"]), torch.tensor(data["t"]),
            torch.tensor(data["Y"]),
            lambda f, x0, t: solve(
                lambda tt, X: tkr.vector_field_fast(A, static, tt, X),
                x0, t))
        u_c = pot(p)
        u_c.backward()
        torch.testing.assert_close(u[c], u_c.detach(), rtol=1e-12, atol=0)
        assert tree_max_rel({k: g[k][c] for k in p},
                            {k: p[k].grad for k in p}) <= 1e-8
    assert all(x.dtype == torch.float64 for x in tree_leaves(g))
