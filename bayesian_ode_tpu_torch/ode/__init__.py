"""ODE solvers of the PyTorch port: adaptive dopri5 and tsit5, the
fixed-grid euler, midpoint and rk4, the continuous adjoint and forward
sensitivities."""
from .adjoint import odeint_adjoint  # noqa: F401
from .odeint import odeint, odeint_with_stats  # noqa: F401
from .sensitivity import odeint_forward_sensitivity  # noqa: F401

__all__ = ["odeint", "odeint_adjoint", "odeint_forward_sensitivity",
           "odeint_with_stats"]
