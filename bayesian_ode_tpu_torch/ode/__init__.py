"""ODE solvers of the PyTorch port: adaptive dopri5 and the fixed-grid
euler, midpoint and rk4, forward."""
from .odeint import odeint, odeint_with_stats  # noqa: F401

__all__ = ["odeint", "odeint_with_stats"]
