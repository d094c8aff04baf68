"""Experiment drivers of the PyTorch port: the GP-ODE sampler, MAP
optimizer, variational and Laplace fits, evidence estimation, the toy
densities and the config grids."""
from .config import (  # noqa: F401
    DEFAULT_VALUES,
    dir_name_for,
    expand_grid,
    load_config,
    write_configs,
)
from .toy import run_toy  # noqa: F401
from .vanderpol_gp import (  # noqa: F401
    build_model,
    run_evidence,
    run_optim,
    run_sampler,
    run_vi,
    worker,
)

__all__ = ["DEFAULT_VALUES", "build_model", "dir_name_for", "expand_grid",
           "load_config", "run_evidence", "run_optim", "run_sampler",
           "run_toy", "run_vi", "worker", "write_configs"]
