"""Public `odeint` for the port: dopri5 and the fixed-grid methods,
forward, increasing times.

Counterpart of `bayesian_ode_tpu/ode/odeint.py` reduced to what the
ported slices need: dopri5 (integrating the true dynamics in
`models/data.py`) and the fixed-grid "euler", "midpoint" and "rk4" (the
generic path the fused rk4 kernels are held to), the latter with the
options `step_size` and `compensated`.  The other methods, the adjoint
and decreasing times are ROADMAP queue 1 item 2.

    ys = odeint(func, y0, t, rtol=1e-7, atol=1e-9, method="dopri5")

`func(t, y)` sees one system, y shaped like y0; ys stacks the solution on a
new leading time axis.  With `batched=True` the leading axis of y0 holds
independent systems, each with its own step size under dopri5, and
`func(t (B,), y)` sees the whole batch.  Time runs in float64 whatever the
state dtype, as the JAX package keeps it under x64.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from .adaptive import AdaptiveConfig, integrate_adaptive
from .fixed_grid import STEP_FUNCS, integrate_fixed_grid

_FIXED_OPTIONS = ("step_size", "compensated")


def odeint_with_stats(func: Callable, y0: torch.Tensor, t, rtol: float = 1e-7,
                      atol: float = 1e-9, method: Optional[str] = None,
                      options: Optional[Dict[str, Any]] = None,
                      batched: bool = False):
    method = method or "dopri5"
    options = dict(options or {})
    if method != "dopri5" and method not in STEP_FUNCS:
        raise NotImplementedError(
            f"method {method!r}: the port has dopri5, euler, midpoint and "
            "rk4 so far (ROADMAP queue 1 item 2 ports the other solvers)")
    allowed = _FIXED_OPTIONS if method in STEP_FUNCS else ()
    if set(options) - set(allowed):
        raise NotImplementedError(
            f"options {sorted(set(options) - set(allowed))} are not ported "
            f"for {method} (ROADMAP queue 1 item 2)")
    ts = torch.as_tensor(t, dtype=torch.float64, device=y0.device)
    if ts.dim() != 1:
        raise ValueError(f"t must be 1-D, got shape {tuple(ts.shape)}")
    if ts.shape[0] >= 2 and not bool((ts[1:] > ts[:-1]).all()):
        raise NotImplementedError(
            "t must be strictly increasing (decreasing time is ROADMAP "
            "queue 1 item 2)")
    if not batched:
        y0 = y0.unsqueeze(0)
        base = func
        func = lambda tt, yy: base(tt[0], yy[0]).unsqueeze(0)  # noqa: E731
    if ts.shape[0] < 2:
        ys = y0.unsqueeze(0)
        B = y0.shape[0]
        zeros = torch.zeros(B, dtype=torch.int64, device=y0.device)
        stats = {"nfe": zeros, "n_accepted": zeros, "n_rejected": zeros,
                 "reached_final_time": torch.ones(B, dtype=torch.bool,
                                                  device=y0.device)}
    elif method in STEP_FUNCS:
        B = y0.shape[0]
        ys, st = integrate_fixed_grid(
            lambda tt, yy: func(tt.expand(B), yy), y0, ts, method, **options)
        stats = {k: torch.full((B,), v, device=y0.device)
                 for k, v in st.items()}
    else:
        cfg = AdaptiveConfig(rtol=rtol, atol=atol)
        ys, stats = integrate_adaptive(func, y0, ts, cfg)
    if not batched:
        ys = ys[:, 0]
        stats = {k: v[0] for k, v in stats.items()}
    return ys, stats


def odeint(func: Callable, y0: torch.Tensor, t, rtol: float = 1e-7,
           atol: float = 1e-9, method: Optional[str] = None,
           options: Optional[Dict[str, Any]] = None,
           batched: bool = False) -> torch.Tensor:
    """Integrate dy/dt = func(t, y) from y(t[0]) = y0 at the times in t."""
    ys, _ = odeint_with_stats(func, y0, t, rtol, atol, method, options,
                              batched)
    return ys
