"""Experiment drivers of the PyTorch port (the GP-ODE sampler so far)."""
from .config import DEFAULT_VALUES, load_config  # noqa: F401
from .vanderpol_gp import build_model, run_sampler, worker  # noqa: F401

__all__ = ["DEFAULT_VALUES", "build_model", "load_config", "run_sampler",
           "worker"]
