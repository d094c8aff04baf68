"""Fused operators of the PyTorch port and their CUDA kernels.

The public fused adaptive engine (`fused_field.py`) with its kernels K2
(recording forward) and K3 (replay backward) over the GP, MLP, spiral and
FitzHugh-Nagumo fields and the DOPRI5 and TSIT5 tableaus, and K1 (the GP
whole solve without records); K4/K5 (rk4 forward and reverse sweep) of the
GP field; K6/K7 (the same) of the MLP field.  All are CUDA C++ under
`csrc/`, built at first use (`_build.py`).  Every wrapper runs its plain
PyTorch version for CPU tensors only.  (The GP registration itself is
`ops.gp_field.gp_field`; its name is the module's.)
"""
from .fhn_dopri5 import (  # noqa: F401
    fhn_dopri5_solve_stats,
    fhn_dopri5_trajectory,
    fhn_field,
    make_fused_fhn_potential_dopri5,
)
from .fused_field import (  # noqa: F401
    FusedField,
    fused_dopri5_stats,
    fused_dopri5_trajectory,
)
from .gp_dopri5 import (  # noqa: F401
    gp_dopri5_solve_whole,
    gp_dopri5_solve_whole_plain,
)
from .gp_dopri5_grad import (  # noqa: F401
    gp_dopri5_trajectory,
    gp_dopri5_trajectory_plain,
    make_fused_gp_potential_dopri5,
)
from .gp_field import (  # noqa: F401
    gp_field_solve_stats,
    gp_field_trajectory,
)
from .gp_rk4 import gp_rk4_trajectory, make_fused_gp_potential  # noqa: F401
from .mlp_dopri5 import (  # noqa: F401
    make_fused_mlp_potential_dopri5,
    mlp_dopri5_solve_stats,
    mlp_dopri5_trajectory,
    mlp_field,
)
from .mlp_rk4 import (  # noqa: F401
    make_fused_mlp_potential,
    mlp_rk4_trajectory,
)
from .spiral_dopri5 import (  # noqa: F401
    make_fused_spiral_potential_dopri5,
    spiral_dopri5_solve_stats,
    spiral_dopri5_trajectory,
    spiral_field,
)

__all__ = [
    "FusedField",
    "fhn_dopri5_solve_stats",
    "fhn_dopri5_trajectory",
    "fhn_field",
    "fused_dopri5_stats",
    "fused_dopri5_trajectory",
    "gp_dopri5_solve_whole",
    "gp_dopri5_solve_whole_plain",
    "gp_dopri5_trajectory",
    "gp_dopri5_trajectory_plain",
    "gp_field_solve_stats",
    "gp_field_trajectory",
    "gp_rk4_trajectory",
    "make_fused_fhn_potential_dopri5",
    "make_fused_gp_potential",
    "make_fused_gp_potential_dopri5",
    "make_fused_mlp_potential",
    "make_fused_mlp_potential_dopri5",
    "make_fused_spiral_potential_dopri5",
    "mlp_dopri5_solve_stats",
    "mlp_dopri5_trajectory",
    "mlp_field",
    "mlp_rk4_trajectory",
    "spiral_dopri5_solve_stats",
    "spiral_dopri5_trajectory",
    "spiral_field",
]
