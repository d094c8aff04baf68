"""Optimizers for MAP baselines: L-BFGS and its line-search interpolation
(counterpart of `bayesian_ode_tpu/optim`)."""
from .lbfgs import (  # noqa: F401
    LBFGSState,
    curvature_update,
    lbfgs_init,
    lbfgs_minimize,
    lbfgs_step,
    two_loop_recursion,
)
from .polyinterp import cubic_min, cubic_min_3pt, quad_min  # noqa: F401

__all__ = [
    "LBFGSState",
    "cubic_min",
    "cubic_min_3pt",
    "curvature_update",
    "lbfgs_init",
    "lbfgs_minimize",
    "lbfgs_step",
    "quad_min",
    "two_loop_recursion",
]
