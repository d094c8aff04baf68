"""Experiment drivers of the PyTorch port: the GP-ODE sampler and MAP
optimizer."""
from .config import DEFAULT_VALUES, load_config  # noqa: F401
from .vanderpol_gp import (  # noqa: F401
    build_model,
    run_optim,
    run_sampler,
    worker,
)

__all__ = ["DEFAULT_VALUES", "build_model", "load_config", "run_optim",
           "run_sampler", "worker"]
