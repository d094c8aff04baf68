"""Quartic dense output within an accepted step.

Counterpart of `bayesian_ode_tpu/ode/interp.py`: fit
p(x) = a x^4 + b x^3 + c x^2 + d x + e on x = (t - t0) / (t1 - t0) from the
endpoint values and slopes and the midpoint value.  `dt` broadcasts against
the state (a per-system step is shaped (B, 1, ...)).
"""
from __future__ import annotations

from typing import List

import torch


def interp_fit(y0, y1, y_mid, f0, f1, dt) -> List[torch.Tensor]:
    a = -2 * dt * f0 + 2 * dt * f1 - 8 * y0 - 8 * y1 + 16 * y_mid
    b = 5 * dt * f0 - 3 * dt * f1 + 18 * y0 + 14 * y1 - 32 * y_mid
    c = -4 * dt * f0 + dt * f1 - 11 * y0 - 5 * y1 + 16 * y_mid
    d = dt * f0
    return [a, b, c, d, y0]


def interp_evaluate(coefficients: List[torch.Tensor], t0, t1, t):
    """Evaluate the fitted quartic at time t (Horner form).  t0, t1 and t
    broadcast against the coefficients; a zero-length interval evaluates at
    x = 0 with the division guarded."""
    same = t1 == t0
    denom = torch.where(same, torch.ones_like(t1), t1 - t0)
    x = torch.where(same, torch.zeros_like(t1), (t - t0) / denom)
    a, b, c, d, e = coefficients
    x = x.to(a.dtype)
    return (((a * x + b) * x + c) * x + d) * x + e
