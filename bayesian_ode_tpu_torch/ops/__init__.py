"""Fused GP dopri5 operators of the PyTorch port and their CUDA kernels.

K1 (whole solve), K2 (recording forward) and K3 (replay backward) are CUDA
C++ under `csrc/`, built at first use (`_build.py`).  Every wrapper runs
its plain PyTorch version for CPU tensors only.
"""
from .gp_dopri5 import (  # noqa: F401
    gp_dopri5_solve_whole,
    gp_dopri5_solve_whole_plain,
)
from .gp_dopri5_grad import (  # noqa: F401
    gp_dopri5_trajectory,
    gp_dopri5_trajectory_plain,
    make_fused_gp_potential_dopri5,
)

__all__ = [
    "gp_dopri5_solve_whole",
    "gp_dopri5_solve_whole_plain",
    "gp_dopri5_trajectory",
    "gp_dopri5_trajectory_plain",
    "make_fused_gp_potential_dopri5",
]
