"""Ground-truth 2-D dynamics: Van der Pol, FitzHugh-Nagumo, Lotka-Volterra.

Counterpart of `bayesian_ode_tpu/models/dynamics.py`.  State is (..., 2).
"""
from __future__ import annotations

import torch


def vdp(t, x):
    """Van der Pol: [x' = v, v' = (1 - x^2) v - x]."""
    p, v = x[..., 0:1], x[..., 1:2]
    return torch.cat([v, (1.0 - p ** 2) * v - p], dim=-1)


def fhn(t, x):
    """FitzHugh-Nagumo."""
    p, w = x[..., 0:1], x[..., 1:2]
    return torch.cat(
        [3.0 * (p - p ** 3 / 3.0 + w), (0.2 - 3.0 * p - 0.2 * w) / 3.0],
        dim=-1)


def lv(t, x):
    """Lotka-Volterra."""
    u, v = x[..., 0:1], x[..., 1:2]
    return torch.cat([1.5 * u - u * v, -3.0 * v + u * v], dim=-1)


DYNAMICS = {"vdp": vdp, "fhn": fhn, "lv": lv}
