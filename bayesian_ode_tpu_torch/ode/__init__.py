"""ODE solvers of the PyTorch port: every method of the JAX package's
registry (`SOLVERS`: the adaptive explicit pairs dopri5, tsit5, dopri8,
bosh3, fehlberg2 and adaptive_heun, the implicit sdirk4 and trbdf2, the
variable-order adams, the fixed-grid euler, midpoint and rk4, the
symplectic steppers and the fixed Adams methods), complex states, the
continuous adjoint, forward sensitivities, dense output and event
detection, each over a batch of systems with its own steps."""
from .adjoint import odeint_adjoint  # noqa: F401
from .dense import DenseSolution, odeint_dense  # noqa: F401
from .events import odeint_event, odeint_event_with_stats  # noqa: F401
from .odeint import SOLVERS, odeint, odeint_with_stats  # noqa: F401
from .sensitivity import odeint_forward_sensitivity  # noqa: F401

__all__ = ["SOLVERS", "DenseSolution", "odeint", "odeint_adjoint",
           "odeint_dense", "odeint_event", "odeint_event_with_stats",
           "odeint_forward_sensitivity", "odeint_with_stats"]
