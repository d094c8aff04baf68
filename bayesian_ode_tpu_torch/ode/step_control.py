"""Error norms and step-size control, batched over independent systems.

Counterpart of `bayesian_ode_tpu/ode/step_control.py`.  Every function takes
a leading batch axis B (one system per row, each with its own step size);
all data-dependent branching is `torch.where`, so a batch advances in
masked lockstep.
"""
from __future__ import annotations

import torch


def _per_system_mean(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=1)


def error_ratio(y1_error, rtol, atol, y0, y1, ulp_floor: float = 32.0):
    """(B,) mean-square error ratio mean((err / tol)^2) per system.

    tol = atol + rtol * max(|y0|, |y1|), floored at `ulp_floor` ulps of the
    state magnitude: below that floor the error estimate is rounding noise
    of the stage combination, and resolving it would collapse the step
    size in float32 (the JAX package measured ~170x NFE inflation at
    rtol=1e-7 without it).
    """
    mag = torch.maximum(y0.abs(), y1.abs())
    tol = atol + rtol * mag
    ulps = ulp_floor * torch.finfo(y1_error.dtype).eps
    tol = torch.maximum(tol, ulps * mag)
    return _per_system_mean((y1_error / tol) ** 2)


def optimal_step_size(last_step, ratio, safety=0.9, ifactor=10.0,
                      dfactor=0.2, order=5):
    """dt' = dt / clip(sqrt(r)^(1/order) / safety, 1/ifactor, 1/dfactor),
    with dfactor disabled when r < 1, and dt * ifactor when r == 0."""
    r = ratio.to(last_step.dtype)
    dfac = torch.where(r < 1.0, torch.ones_like(r), torch.full_like(r, dfactor))
    err = torch.sqrt(torch.clamp_min(r, torch.finfo(last_step.dtype).tiny))
    factor = torch.maximum(
        torch.full_like(r, 1.0 / ifactor),
        torch.minimum(err ** (1.0 / order) / safety, 1.0 / dfac),
    )
    return torch.where(r == 0.0, last_step * ifactor, last_step / factor)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_per_system_mean(x * x))


def select_initial_step(func, t0, y0, order, rtol, atol, f0):
    """Hairer, Norsett & Wanner II.4 initial step, per system (B,).

    Branch-free, as `bayesian_ode_tpu.ode.step_control.select_initial_step`.
    Costs one extra RHS evaluation.
    """
    scale = atol + y0.abs() * rtol
    d0 = _rms(y0 / scale).to(t0.dtype)
    d1 = _rms(f0 / scale).to(t0.dtype)
    tiny = torch.finfo(t0.dtype).tiny
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6),
                     0.01 * d0 / torch.clamp_min(d1, tiny))
    bshape = (-1,) + (1,) * (y0.dim() - 1)
    y1 = y0 + h0.to(y0.dtype).reshape(bshape) * f0
    f1 = func(t0 + h0, y1)
    d2 = _rms((f1 - f0) / scale).to(t0.dtype) / h0
    flat = (d1 <= 1e-15) & (d2 <= 1e-15)
    h1_flat = torch.clamp_min(h0 * 1e-3, 1e-6)
    h1_steep = (0.01 / torch.clamp_min(torch.maximum(d1, d2), tiny)) ** (
        1.0 / (order + 1.0))
    h1 = torch.where(flat, h1_flat, h1_steep)
    return torch.minimum(100 * h0, h1)
