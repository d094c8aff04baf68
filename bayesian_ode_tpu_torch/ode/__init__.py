"""Adaptive ODE solvers of the PyTorch port (dopri5 forward so far)."""
from .odeint import odeint, odeint_with_stats  # noqa: F401

__all__ = ["odeint", "odeint_with_stats"]
