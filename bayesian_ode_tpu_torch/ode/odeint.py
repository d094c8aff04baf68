"""Public `odeint` for the port: every solver of the JAX package's registry.

Counterpart of `bayesian_ode_tpu/ode/odeint.py`:

    ys = odeint(func, y0, t, rtol=1e-7, atol=1e-9, method="dopri5",
                options={})

`func(t, y)` sees one system; y0 is a tensor or a tree of tensors (dict,
list, tuple), and ys stacks the solution on a new leading time axis.  `t`
is monotonic: decreasing times integrate s = -t forward with the negated
field (the reference's reversal trick; options={"reverse": bool} pins the
direction).  With `batched=True` the leading axis of every leaf of y0
holds independent systems, each with its own step size, order, Newton
iterations and history, as the JAX package's vmap of the per-system
solve; `func(t (B,), y)` sees the whole batch, and the adaptive methods
also take per-system times t of shape (T, B).  Time runs in float64
whatever the state dtype, as the JAX package keeps it under x64.  Complex
leaves are solved as real ones with a trailing [Re, Im] axis
(`complex_to_real`).

`SOLVERS` maps each method name to its batched solver:
  - adaptive RK: "dopri5", "tsit5", "dopri8", "bosh3", "fehlberg2",
    "adaptive_heun" (the options of `adaptive.AdaptiveConfig`, and
    `interp` for another dense output);
  - implicit: "sdirk4", "trbdf2" (`ode/dirk.py`; also newton_iters,
    newton_kappa, error_filter);
  - variable-order Adams: "adams" (`ode/vcabm.py`; max_order, safety,
    ifactor, dfactor, max_num_steps, mode, max_steps_per_interval);
  - fixed grid: "euler", "midpoint", "rk4" and the symplectic
    "symplectic_euler", "leapfrog", "verlet", "yoshida4" (step_size,
    compensated), "explicit_adams" and "fixed_adams"
    (`ode/fixed_adams.py`; step_size, max_order, max_iters, and rtol/atol
    of the corrector).
Options a method does not read are ignored, as the JAX package ignores
them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..utils.pytree import tree_leaves, tree_map, tree_unflatten
from . import fixed_adams as _fixed_adams
from . import vcabm as _vcabm
from .adaptive import AdaptiveConfig, integrate_adaptive
from .fixed_grid import integrate_fixed_grid
from .tableaus import ADAPTIVE_HEUN, BOSH3, DOPRI5, DOPRI8, FEHLBERG2, TSIT5

ADAPTIVE_OPTION_KEYS = (
    "first_step", "safety", "ifactor", "dfactor", "max_num_steps", "mode",
    "max_steps_per_interval", "compensated", "ulp_floor", "controller",
    "newton_iters", "newton_kappa", "error_filter", "norm_weights",
)


def adaptive_config(rtol, atol, options: Dict[str, Any]) -> AdaptiveConfig:
    return AdaptiveConfig(rtol=float(rtol), atol=float(atol),
                          **{k: options[k] for k in ADAPTIVE_OPTION_KEYS
                             if k in options})


def _solve_adaptive(tableau, interp_kind):
    def solve(func, y0, ts, rtol, atol, options):
        cfg = adaptive_config(rtol, atol, options)
        kind = options.get("interp", interp_kind)
        if kind == "quartic" and tableau.c_mid is None:
            raise ValueError(
                "options={'interp': 'quartic'} needs a tableau with c_mid "
                "midpoint weights")
        return integrate_adaptive(func, y0, ts, cfg, tableau, kind)

    return solve


def _solve_dirk(method):
    def solve(func, y0, ts, rtol, atol, options):
        from .dirk import DIRK_TABLEAUS, dirk_step

        cfg = adaptive_config(rtol, atol, options)
        if cfg.compensated:
            raise ValueError(
                "options={'compensated': True} is not supported by the "
                "implicit (DIRK) methods: y1 comes from Newton stage "
                "solves, not an explicit increment commit")
        return integrate_adaptive(func, y0, ts, cfg, DIRK_TABLEAUS[method],
                                  "hermite", step_impl=dirk_step)

    return solve


def _shared_times(ts, method):
    if ts.dim() != 1:
        raise ValueError(f"method {method!r} steps on one grid for the "
                         "whole batch: t must be 1-D")
    return ts


def _solve_fixed(method):
    def solve(func, y0, ts, rtol, atol, options):
        ts = _shared_times(ts, method)
        B = tree_leaves(y0)[0].shape[0]
        ys, st = integrate_fixed_grid(
            lambda tt, yy: func(tt.expand(B), yy), y0, ts, method,
            options.get("step_size"), options.get("compensated", False))
        dev = ts.device
        stats = {"nfe": torch.full((B,), st["nfe"], device=dev),
                 "n_accepted": torch.full((B,), st["n_accepted"],
                                          device=dev),
                 "n_rejected": torch.zeros(B, dtype=torch.int64, device=dev),
                 "reached_final_time": torch.ones(B, dtype=torch.bool,
                                                  device=dev)}
        return ys, stats

    return solve


def _solve_fixed_adams(implicit):
    def solve(func, y0, ts, rtol, atol, options):
        return _fixed_adams.integrate_abm(
            func, y0, _shared_times(ts, "fixed_adams"),
            rtol=options.get("rtol", rtol), atol=options.get("atol", atol),
            implicit=implicit, max_iters=options.get("max_iters", 4),
            max_order=options.get("max_order", 12),
            step_size=options.get("step_size"))

    return solve


def _solve_vcabm(func, y0, ts, rtol, atol, options):
    return _vcabm.integrate_vcabm(
        func, y0, ts, rtol=rtol, atol=atol,
        max_order=options.get("max_order", 12),
        safety=options.get("safety", 0.9),
        ifactor=options.get("ifactor", 10.0),
        dfactor=options.get("dfactor", 0.2),
        max_num_steps=options.get("max_num_steps", 2**20),
        mode=options.get("mode", "while"),
        max_steps_per_interval=options.get("max_steps_per_interval", 256))


# the JAX package's registry (and the reference's names); each solver
# takes (func(t (B,), y), y0, ts (T,) or (T, B), rtol, atol, options) and
# returns (ys (T, B, ...), per-system stats)
SOLVERS: Dict[str, Callable] = {
    "dopri5": _solve_adaptive(DOPRI5, "quartic"),
    "tsit5": _solve_adaptive(TSIT5, "stages"),
    # DOP853: composite 8(5,3) error and the 7th-order dense output (3 more
    # RHS evaluations a step); options={"interp": "quartic"} is the cheap
    # 4th-order fit
    "dopri8": _solve_adaptive(DOPRI8, "dop853"),
    "bosh3": _solve_adaptive(BOSH3, "hermite"),
    "fehlberg2": _solve_adaptive(FEHLBERG2, "hermite"),
    "adaptive_heun": _solve_adaptive(ADAPTIVE_HEUN, "hermite"),
    "euler": _solve_fixed("euler"),
    "midpoint": _solve_fixed("midpoint"),
    "rk4": _solve_fixed("rk4"),
    # separable Hamiltonian systems, state (q, p) (ode/symplectic.py)
    "symplectic_euler": _solve_fixed("symplectic_euler"),
    "leapfrog": _solve_fixed("leapfrog"),
    "verlet": _solve_fixed("verlet"),
    "yoshida4": _solve_fixed("yoshida4"),
    "explicit_adams": _solve_fixed_adams(implicit=False),
    "fixed_adams": _solve_fixed_adams(implicit=True),
    "adams": _solve_vcabm,
    "sdirk4": _solve_dirk("sdirk4"),
    "trbdf2": _solve_dirk("trbdf2"),
}
# the methods with an accept/reject loop (no fixed grid)
ADAPTIVE_METHODS = ("dopri5", "tsit5", "dopri8", "bosh3", "fehlberg2",
                    "adaptive_heun", "adams", "sdirk4", "trbdf2")


def check_method(method: str) -> None:
    if method not in SOLVERS:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(SOLVERS)}")


def solve_batched(func: Callable, y0, ts: torch.Tensor, rtol, atol,
                  method: str, options: Dict[str, Any]):
    """Solve a batch (every leaf of y0 with a leading system axis B) at the
    increasing float64 times ts (T,) or (T, B), T >= 2.  func(t (B,), y)
    -> tree.  Returns (ys, stats) with per-system stats."""
    check_method(method)
    return SOLVERS[method](func, y0, ts, rtol, atol, dict(options))


def as_times(t, device, batched: bool = False) -> torch.Tensor:
    """t as a float64 tensor on `device` (autograd kept): 1-D, or (T, B)
    per-system times in a batch."""
    ts = t if torch.is_tensor(t) else torch.as_tensor(t)
    ts = ts.to(device=device, dtype=torch.float64)
    if ts.dim() != 1 and not (batched and ts.dim() == 2):
        raise ValueError(f"t must be 1-D, got shape {tuple(ts.shape)}")
    return ts


def reverse_time(func: Callable, ts: torch.Tensor,
                 reverse: Optional[bool] = None):
    """(func, ts) canonicalised to increasing time: where t decreases (or
    `reverse` says so), s = -t with dy/ds = -f(-s, y)."""
    if ts.shape[0] < 2:
        return func, ts
    if reverse is None:
        reverse = bool((ts[1] < ts[0]).any())
    if reverse:
        base = func
        func = lambda s, y: tree_map(torch.neg, base(-s, y))  # noqa: E731
        ts = -ts
    if not bool((ts[1:] >= ts[:-1]).all()):
        raise ValueError("t must be monotonic")
    return func, ts


def unbatch(func: Callable, y0):
    """A one-system problem as a batch of one: (batched func, y0)."""
    def batched(tt, yy):
        out = func(tt[0], tree_map(lambda l: l[0], yy))
        return tree_map(lambda l: l.unsqueeze(0), out)

    return batched, tree_map(lambda l: l.unsqueeze(0), y0)


def complex_to_real(func: Callable, y0):
    """View-as-real transform of complex state leaves: each complex leaf z
    becomes the real leaf view_as_real(z), [Re z, Im z] on a new trailing
    axis (the JAX package's stack([Re, Im], -1)), and func is wrapped to
    convert in and out, so every solver and its error control see real
    components.  Returns (func, y0, unpack), unpack mapping a solution
    tree back to complex leaves; a no-op where no leaf is complex."""
    is_cplx = [torch.is_complex(l) for l in tree_leaves(y0)]
    if not any(is_cplx):
        return func, y0, lambda ys: ys

    def pack(tree):
        return tree_unflatten(y0, [
            torch.view_as_real(l) if c else l
            for l, c in zip(tree_leaves(tree), is_cplx)])

    def unpack(tree):
        return tree_unflatten(y0, [
            torch.view_as_complex(l.contiguous()) if c else l
            for l, c in zip(tree_leaves(tree), is_cplx)])

    def wrapped(t, y_real):
        return pack(func(t, unpack(y_real)))

    return wrapped, pack(y0), unpack


def odeint_with_stats(func: Callable, y0, t, rtol: float = 1e-7,
                      atol: float = 1e-9, method: Optional[str] = None,
                      options: Optional[Dict[str, Any]] = None,
                      batched: bool = False):
    """Like `odeint` but also returns the solver statistics nfe,
    n_accepted, n_rejected and reached_final_time (per system when
    batched; the fixed Adams methods add corrector_fails)."""
    if options is not None and method is None:
        raise ValueError("cannot supply `options` without specifying "
                         "`method`")
    method = method or "dopri5"
    options = dict(options or {})
    check_method(method)
    func, y0, unpack = complex_to_real(func, y0)
    dev = tree_leaves(y0)[0].device
    ts = as_times(t, dev, batched)
    func, ts = reverse_time(func, ts, options.pop("reverse", None))
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
    return unpack(ys), stats


def odeint(func: Callable, y0, t, rtol: float = 1e-7, atol: float = 1e-9,
           method: Optional[str] = None,
           options: Optional[Dict[str, Any]] = None, batched: bool = False):
    """Integrate dy/dt = func(t, y) from y(t[0]) = y0 at the times in t."""
    ys, _ = odeint_with_stats(func, y0, t, rtol, atol, method, options,
                              batched)
    return ys
