"""One explicit Runge-Kutta step over a Butcher tableau, batched.

Counterpart of `bayesian_ode_tpu/ode/runge_kutta.py::runge_kutta_step` for
FSAL pairs (dopri5).  The state carries a leading batch axis; `t0` and `dt`
are (B,) in the time dtype and are cast to the state dtype for the stage
arithmetic, as the JAX package does.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from .tableaus import ButcherTableau


def _bcast(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(like.dtype).reshape((-1,) + (1,) * (like.dim() - 1))


def weighted_stage_sum(dt, weights, k: List[torch.Tensor]) -> torch.Tensor:
    """dt * sum_i weights[i] * k[i], skipping zero weights."""
    acc = sum(w * k_ for w, k_ in zip(weights, k) if w != 0)
    return _bcast(dt, k[0]) * acc


def runge_kutta_step(func: Callable, y0, f0, t0, dt,
                     tableau: ButcherTableau):
    """Returns (y1, f1, y1_error, k), k the stage derivatives with
    f(t1, y1) last (FSAL)."""
    k = [f0]
    dtc = _bcast(dt, y0)
    yi = y0
    for alpha_i, beta_i in zip(tableau.alpha, tableau.beta):
        yi = y0 + dtc * sum(b * k_ for b, k_ in zip(beta_i, k) if b != 0)
        k.append(func(t0 + alpha_i * dt, yi))
    y1_error = weighted_stage_sum(dt, tableau.c_error, k)
    return yi, k[-1], y1_error, k


def rk4_alt_step(func: Callable, t, dt, y, k1=None):
    """Increment of one 3/8-rule RK4 step (the reference's fixed-grid
    RK4), in the operation order of the JAX package's `rk4_alt_step`.
    `t` and `dt` are in the time dtype; dt is cast to the state dtype for
    the stage arithmetic."""
    dtc = dt.to(y.dtype)
    if k1 is None:
        k1 = func(t, y)
    k2 = func(t + dt / 3, y + dtc * k1 / 3)
    k3 = func(t + dt * 2 / 3, y + dtc * (-k1 / 3 + k2))
    k4 = func(t + dt, y + dtc * (k1 - k2 + k3))
    return (k1 + 3 * k2 + 3 * k3 + k4) * (dtc / 8)
