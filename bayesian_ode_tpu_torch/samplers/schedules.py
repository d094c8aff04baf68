"""Step-size schedules shared by the samplers.

Counterpart of `bayesian_ode_tpu/samplers/schedules.py`: pure functions of
the iteration index carried in each kernel state.
"""
from __future__ import annotations

import math
from typing import Callable


def constant(lr: float) -> Callable:
    return lambda t: float(lr)


def polynomial_decay(lr0: float, gamma: float = 0.55, t0: float = 100.0,
                     alpha: float = 1.0) -> Callable:
    """lr(t) = lr0 / (t0 + alpha*t)^gamma (reference langevin.py:205-210)."""
    return lambda t: lr0 / (t0 + alpha * t) ** gamma


def cyclical_cosine(lr0: float, num_cycles: int,
                    total_iters: int) -> Callable:
    """Cyclical cosine schedule of cSGLD (reference langevin.py:1662-1670):
    lr(t) = lr0/2 * (cos(pi r(t)) + 1), r(t) = `cycle_position`."""
    return lambda t: lr0 / 2.0 * (
        math.cos(math.pi * cycle_position(t, num_cycles, total_iters))
        + 1.0)


def cycle_position(t: int, num_cycles: int, total_iters: int) -> float:
    """r(t) in [0, 1): ((t - 1) mod ceil) / ceil with
    ceil = (total_iters + num_cycles) // num_cycles."""
    ceil = (total_iters + num_cycles) // num_cycles
    return ((t - 1) % ceil) / ceil


def resolve(step_size) -> Callable:
    """Accept either a float or a schedule callable."""
    if callable(step_size):
        return step_size
    return constant(float(step_size))
