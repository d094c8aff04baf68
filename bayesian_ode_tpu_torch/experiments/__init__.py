"""Experiment drivers of the PyTorch port: the GP-ODE sampler, MAP
optimizer, variational and Laplace fits, and evidence estimation."""
from .config import DEFAULT_VALUES, load_config  # noqa: F401
from .vanderpol_gp import (  # noqa: F401
    build_model,
    run_evidence,
    run_optim,
    run_sampler,
    run_vi,
    worker,
)

__all__ = ["DEFAULT_VALUES", "build_model", "load_config", "run_evidence",
           "run_optim", "run_sampler", "run_vi", "worker"]
