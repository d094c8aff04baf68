"""Samplers of the PyTorch port: the batched Langevin family and SVGD."""
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
    kernel_stein_discrepancy,
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
from .stein import (  # noqa: F401
    SVGDState,
    pairwise_sq_dists,
    rbf_bandwidth,
    rbf_kernel,
    svgd,
    svgd_batched,
    svgd_direction,
)

__all__ = [
    "AdamSGLDState",
    "BatchLangevinState",
    "BatchPreconditionedState",
    "SVGDState",
    "TransitionKernel",
    "acceptance_rate",
    "adam_sgld_batched",
    "autocovariance",
    "batch_value_and_grad",
    "csgld_batched",
    "ess",
    "kernel_stein_discrepancy",
    "langevin_noise_scale",
    "mala_batched",
    "pairwise_sq_dists",
    "psgld_batched",
    "psgld_preconditioner",
    "rbf_bandwidth",
    "rbf_kernel",
    "sample_chain",
    "schedules",
    "sgld_batched",
    "split_rhat",
    "svgd",
    "svgd_batched",
    "svgd_direction",
]
