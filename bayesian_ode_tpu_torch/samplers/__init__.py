"""Samplers of the PyTorch port: the batched Langevin family."""
from . import schedules  # noqa: F401
from .base import (  # noqa: F401
    TransitionKernel,
    batch_value_and_grad,
    langevin_noise_scale,
    sample_chain,
)
from .diagnostics import (  # noqa: F401
    acceptance_rate,
    autocovariance,
    ess,
    split_rhat,
)
from .langevin import (  # noqa: F401
    AdamSGLDState,
    BatchLangevinState,
    BatchPreconditionedState,
    adam_sgld_batched,
    csgld_batched,
    mala_batched,
    psgld_batched,
    psgld_preconditioner,
    sgld_batched,
)

__all__ = [
    "AdamSGLDState",
    "BatchLangevinState",
    "BatchPreconditionedState",
    "TransitionKernel",
    "acceptance_rate",
    "adam_sgld_batched",
    "autocovariance",
    "batch_value_and_grad",
    "csgld_batched",
    "ess",
    "langevin_noise_scale",
    "mala_batched",
    "psgld_batched",
    "psgld_preconditioner",
    "sample_chain",
    "schedules",
    "sgld_batched",
    "split_rhat",
]
