"""Fused operators of the PyTorch port and their CUDA kernels.

K1 (whole dopri5 solve), K2 (recording forward) and K3 (replay backward)
of the GP field; K4/K5 (rk4 forward and reverse sweep) of the GP field;
K6/K7 (the same) of the MLP field.  All are CUDA C++ under `csrc/`, built
at first use (`_build.py`).  Every wrapper runs its plain PyTorch version
for CPU tensors only.
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
from .gp_rk4 import gp_rk4_trajectory, make_fused_gp_potential  # noqa: F401
from .mlp_rk4 import (  # noqa: F401
    make_fused_mlp_potential,
    mlp_rk4_trajectory,
)

__all__ = [
    "gp_dopri5_solve_whole",
    "gp_dopri5_solve_whole_plain",
    "gp_dopri5_trajectory",
    "gp_dopri5_trajectory_plain",
    "gp_rk4_trajectory",
    "make_fused_gp_potential",
    "make_fused_gp_potential_dopri5",
    "make_fused_mlp_potential",
    "mlp_rk4_trajectory",
]
