"""Step-size schedules shared by the samplers.

Counterpart of `bayesian_ode_tpu/samplers/schedules.py`: pure functions of
the iteration index carried in each kernel state.
"""
from __future__ import annotations

from typing import Callable


def constant(lr: float) -> Callable:
    return lambda t: float(lr)


def polynomial_decay(lr0: float, gamma: float = 0.55, t0: float = 100.0,
                     alpha: float = 1.0) -> Callable:
    """lr(t) = lr0 / (t0 + alpha*t)^gamma (reference langevin.py:205-210)."""
    return lambda t: lr0 / (t0 + alpha * t) ** gamma


def resolve(step_size) -> Callable:
    """Accept either a float or a schedule callable."""
    if callable(step_size):
        return step_size
    return constant(float(step_size))
