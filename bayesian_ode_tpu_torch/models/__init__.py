"""ODE vector fields, neural ODE/SDE models, target densities and data of
the PyTorch port."""
from . import (  # noqa: F401
    cnf,
    fhn_inference,
    kernel_regression,
    latent_ode,
    latent_sde,
    linear_regression,
    mlp,
    odenet,
    spiral,
    toy_densities,
)
from .data import make_dataset  # noqa: F401
from .dynamics import DYNAMICS, fhn, lv, vdp  # noqa: F401
from .toy_densities import TOY_POTENTIALS  # noqa: F401

__all__ = ["DYNAMICS", "TOY_POTENTIALS", "cnf", "fhn", "fhn_inference",
           "kernel_regression", "latent_ode", "latent_sde",
           "linear_regression", "lv", "make_dataset", "mlp", "odenet",
           "spiral",
           "toy_densities", "vdp"]
