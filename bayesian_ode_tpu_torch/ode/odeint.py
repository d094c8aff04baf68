"""Public `odeint` for the port: dopri5, tsit5 and the fixed-grid methods.

Counterpart of `bayesian_ode_tpu/ode/odeint.py`:

    ys = odeint(func, y0, t, rtol=1e-7, atol=1e-9, method="dopri5",
                options={})

`func(t, y)` sees one system; y0 is a tensor or a tree of tensors (dict,
list, tuple), and ys stacks the solution on a new leading time axis.  `t`
is strictly monotonic: decreasing times integrate s = -t forward with the
negated field (the reference's reversal trick).  With `batched=True` the
leading axis of every leaf of y0 holds independent systems, each with its
own step size under the adaptive methods, and `func(t (B,), y)` sees the
whole batch.  Time runs in float64 whatever the state dtype, as the JAX
package keeps it under x64.

Methods: "dopri5" and "tsit5" (adaptive, the options of
`adaptive.AdaptiveConfig`), "euler", "midpoint" and "rk4" (fixed grid, the
options `step_size` and `compensated`).  The JAX package's other solvers
and options raise NotImplementedError naming the ROADMAP item that ports
them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..utils.pytree import tree_leaves, tree_map
from .adaptive import AdaptiveConfig, integrate_adaptive
from .fixed_grid import STEP_FUNCS, integrate_fixed_grid
from .tableaus import DOPRI5, TSIT5

ADAPTIVE = {"dopri5": (DOPRI5, "quartic"), "tsit5": (TSIT5, "stages")}
_ADAPTIVE_OPTIONS = ("first_step", "safety", "ifactor", "dfactor",
                     "max_num_steps", "mode", "ulp_floor", "controller",
                     "norm_weights")
_FIXED_OPTIONS = ("step_size", "compensated")
# the JAX package's other solvers (ROADMAP queue 1 item 16)
_UNPORTED_METHODS = ("adams", "bosh3", "dopri8", "fehlberg2",
                     "adaptive_heun", "sdirk4", "trbdf2", "explicit_adams",
                     "fixed_adams", "symplectic_euler", "leapfrog", "verlet",
                     "yoshida4")
# the JAX package's other adaptive options, by the ROADMAP item that ports
# them: the Kahan-compensated adaptive carry, the bounded mode's
# per-interval cap and other dense outputs (2); the implicit solvers'
# Newton and error-filter settings (16)
_UNPORTED_OPTIONS = {"compensated": 2, "max_steps_per_interval": 2,
                     "interp": 2, "newton_iters": 16, "newton_kappa": 16,
                     "error_filter": 16}


def _check_method(method: str) -> None:
    if method in _UNPORTED_METHODS:
        raise NotImplementedError(
            f"method {method!r}: the port has dopri5, tsit5, euler, "
            "midpoint and rk4 (ROADMAP queue 1 item 16 ports the others)")
    if method not in ADAPTIVE and method not in STEP_FUNCS:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(set(ADAPTIVE) | set(STEP_FUNCS))}")


def _config(method: str, rtol, atol, options: Dict[str, Any]):
    """The adaptive solver's `AdaptiveConfig` from `options`, or the fixed
    grid's keyword options; unported options raise."""
    options = dict(options)
    interp = options.get("interp")
    if interp is not None and method in ADAPTIVE \
            and interp == ADAPTIVE[method][1]:
        options.pop("interp")
    for key in options:
        if key in _UNPORTED_OPTIONS and not (
                key == "compensated" and method in STEP_FUNCS):
            raise NotImplementedError(
                f"option {key!r} is not ported (ROADMAP queue 1 item "
                f"{_UNPORTED_OPTIONS[key]})")
    allowed = _ADAPTIVE_OPTIONS if method in ADAPTIVE else _FIXED_OPTIONS
    extra = set(options) - set(allowed)
    if extra:
        raise NotImplementedError(
            f"options {sorted(extra)} are not ported for {method} (ROADMAP "
            "queue 1 item 2)")
    if method in ADAPTIVE:
        return AdaptiveConfig(rtol=float(rtol), atol=float(atol), **options)
    return options


def solve_batched(func: Callable, y0, ts: torch.Tensor, rtol, atol,
                  method: str, options: Dict[str, Any]):
    """Solve a batch (every leaf of y0 with a leading system axis B) at the
    increasing float64 times ts (T,), T >= 2.  func(t (B,), y) -> tree.
    Returns (ys, stats) with per-system stats."""
    _check_method(method)
    cfg = _config(method, rtol, atol, options)
    B = tree_leaves(y0)[0].shape[0]
    if method in ADAPTIVE:
        tableau, interp = ADAPTIVE[method]
        return integrate_adaptive(func, y0, ts, cfg, tableau, interp)
    ys, st = integrate_fixed_grid(lambda tt, yy: func(tt.expand(B), yy), y0,
                                  ts, method, **cfg)
    dev = ts.device
    stats = {"nfe": torch.full((B,), st["nfe"], device=dev),
             "n_accepted": torch.full((B,), st["n_accepted"], device=dev),
             "n_rejected": torch.zeros(B, dtype=torch.int64, device=dev),
             "reached_final_time": torch.ones(B, dtype=torch.bool,
                                              device=dev)}
    return ys, stats


def as_times(t, device) -> torch.Tensor:
    """t as a 1-D float64 tensor on `device` (autograd kept)."""
    ts = t if torch.is_tensor(t) else torch.as_tensor(t)
    ts = ts.to(device=device, dtype=torch.float64)
    if ts.dim() != 1:
        raise ValueError(f"t must be 1-D, got shape {tuple(ts.shape)}")
    return ts


def reverse_time(func: Callable, ts: torch.Tensor):
    """(func, ts) canonicalised to increasing time: where t decreases,
    s = -t with dy/ds = -f(-s, y)."""
    if ts.shape[0] < 2:
        return func, ts
    if bool(ts[1] < ts[0]):
        base = func
        func = lambda s, y: tree_map(torch.neg, base(-s, y))  # noqa: E731
        ts = -ts
    if not bool((ts[1:] > ts[:-1]).all()):
        raise ValueError("t must be strictly monotonic")
    return func, ts


def unbatch(func: Callable, y0):
    """A one-system problem as a batch of one: (batched func, y0)."""
    def batched(tt, yy):
        out = func(tt[0], tree_map(lambda l: l[0], yy))
        return tree_map(lambda l: l.unsqueeze(0), out)

    return batched, tree_map(lambda l: l.unsqueeze(0), y0)


def check_real(y0) -> None:
    if any(torch.is_complex(l) for l in tree_leaves(y0)):
        raise NotImplementedError(
            "complex states are not ported (ROADMAP queue 1 item 2)")


def odeint_with_stats(func: Callable, y0, t, rtol: float = 1e-7,
                      atol: float = 1e-9, method: Optional[str] = None,
                      options: Optional[Dict[str, Any]] = None,
                      batched: bool = False):
    """Like `odeint` but also returns the solver statistics nfe,
    n_accepted, n_rejected and reached_final_time (per system when
    batched)."""
    if options is not None and method is None:
        raise ValueError("cannot supply `options` without specifying "
                         "`method`")
    method = method or "dopri5"
    options = dict(options or {})
    _check_method(method)
    check_real(y0)
    dev = tree_leaves(y0)[0].device
    ts = as_times(t, dev)
    func, ts = reverse_time(func, ts)
    if not batched:
        func, y0 = unbatch(func, y0)
    B = tree_leaves(y0)[0].shape[0]
    if ts.shape[0] < 2:
        ys = tree_map(lambda l: l.unsqueeze(0), y0)
        zeros = torch.zeros(B, dtype=torch.int64, device=dev)
        stats = {"nfe": zeros, "n_accepted": zeros, "n_rejected": zeros,
                 "reached_final_time": torch.ones(B, dtype=torch.bool,
                                                  device=dev)}
    else:
        ys, stats = solve_batched(func, y0, ts, rtol, atol, method, options)
    if not batched:
        ys = tree_map(lambda l: l[:, 0], ys)
        stats = {k: v[0] for k, v in stats.items()}
    return ys, stats


def odeint(func: Callable, y0, t, rtol: float = 1e-7, atol: float = 1e-9,
           method: Optional[str] = None,
           options: Optional[Dict[str, Any]] = None, batched: bool = False):
    """Integrate dy/dt = func(t, y) from y(t[0]) = y0 at the times in t."""
    ys, _ = odeint_with_stats(func, y0, t, rtol, atol, method, options,
                              batched)
    return ys
