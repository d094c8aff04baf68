"""Samplers of the PyTorch port (the main path's SGLD and pSGLD so far)."""
from . import schedules  # noqa: F401
from .base import (  # noqa: F401
    TransitionKernel,
    batch_value_and_grad,
    langevin_noise_scale,
    sample_chain,
)
from .diagnostics import autocovariance, ess, split_rhat  # noqa: F401
from .langevin import (  # noqa: F401
    BatchLangevinState,
    BatchPreconditionedState,
    psgld_batched,
    sgld_batched,
)

__all__ = [
    "BatchLangevinState",
    "BatchPreconditionedState",
    "TransitionKernel",
    "autocovariance",
    "batch_value_and_grad",
    "ess",
    "langevin_noise_scale",
    "psgld_batched",
    "sample_chain",
    "schedules",
    "sgld_batched",
    "split_rhat",
]
