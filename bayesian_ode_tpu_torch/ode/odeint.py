"""Public `odeint` for the port: dopri5, forward, increasing times.

Counterpart of `bayesian_ode_tpu/ode/odeint.py` reduced to what the
main-path slice needs (integrating the true dynamics in
`models/data.py`).  The other methods, the adjoint and decreasing times
are ROADMAP queue 1 item 2.

    ys = odeint(func, y0, t, rtol=1e-7, atol=1e-9, method="dopri5")

`func(t, y)` sees one system, y shaped like y0; ys stacks the solution on a
new leading time axis.  With `batched=True` the leading axis of y0 holds
independent systems, each with its own step size, and `func(t (B,), y)`
sees the whole batch.  Time runs in float64 whatever the state dtype, as
the JAX package keeps it under x64.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from .adaptive import AdaptiveConfig, integrate_adaptive


def odeint_with_stats(func: Callable, y0: torch.Tensor, t, rtol: float = 1e-7,
                      atol: float = 1e-9, method: Optional[str] = None,
                      options: Optional[Dict[str, Any]] = None,
                      batched: bool = False):
    method = method or "dopri5"
    if method != "dopri5":
        raise NotImplementedError(
            f"method {method!r}: the port has only dopri5 so far "
            "(ROADMAP queue 1 item 2 ports the other solvers)")
    if options:
        raise NotImplementedError(
            f"options {sorted(options)} are not ported (ROADMAP queue 1 "
            "item 2)")
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
