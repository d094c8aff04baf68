"""Stochastic differential equations of the port: fixed-grid solvers, the
reversible-Heun adjoint and Euler-Maruyama pseudo-likelihood potentials
(counterpart of `bayesian_ode_tpu/sde`)."""
from .sdeint import SDE_METHODS, sdeint  # noqa: F401
from .adjoint import sdeint_adjoint  # noqa: F401
from .inference import (  # noqa: F401
    em_log_likelihood,
    make_gp_sde_potential,
    make_gp_sde_potential_batched,
    make_sde_potential,
)

__all__ = [
    "SDE_METHODS",
    "em_log_likelihood",
    "make_gp_sde_potential",
    "make_gp_sde_potential_batched",
    "make_sde_potential",
    "sdeint",
    "sdeint_adjoint",
]
