"""Event-terminated integration: `odeint_event`, batched.

Counterpart of `bayesian_ode_tpu/ode/events.py` (the API of upstream
torchdiffeq's odeint_event):

    event_t, ys = odeint_event(func, y0, t0, event_fn=g, ...)

integrates from t0 until g(t, y) first changes sign and returns the event
time and ys = [y(t0), y(event_t)] on a new leading axis.  With
`batched=True` every system of the batch (func(t (B,), y), g(t (B,), y)
-> (B,)) marches to its own event.

1. Detection: the adaptive step loop (`adaptive.adaptive_step`, or the
   DIRK step) marches every system until an accepted step flips
   sign(g(t1, y1)) against sign(g(t0, y0)), in masked lockstep (one host
   read of the active mask a step).  g(t0, y0) == 0 is an immediate event.
2. Localization: a fixed count of bisections (60 for float64 time) of
   g(t, interp(t)) on the crossing step's dense output: a host constant,
   no data-dependent loop.
3. Differentiation by the implicit function theorem: the trajectory is
   re-solved to the detached event time through `odeint_interface`
   (`odeint`, with options={"mode": "bounded"} for autograd through the
   loop, or `odeint_adjoint`), and

       event_t = t* - g(t*, y*) / (dg/dt)|detached
       y_event = y* + f(t*, y*)|detached (event_t - t*)

   are a Newton polish of the bisection root in value and carry the
   moving-boundary terms in their derivatives.

No event within the budget or `t_max`: event_t is NaN, event_found
False, and the state is the march's last accepted one.  As in
torchdiffeq, an event entered and left within one accepted step is
missed.  Fixed-grid methods and "adams" (no dense output) raise.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..utils.pytree import tree_leaves, tree_map
from .adaptive import (adaptive_step, can_step, evaluate_at,
                       init_adaptive_state, select_state)
from .odeint import adaptive_config, odeint, unbatch
from .tableaus import ADAPTIVE_HEUN, BOSH3, DOPRI5, DOPRI8, FEHLBERG2, TSIT5


def method_triple(method: str):
    """(tableau, interp_kind, step_impl) of an adaptive method with dense
    output."""
    table = {
        "dopri5": (DOPRI5, "quartic", adaptive_step),
        "dopri8": (DOPRI8, "dop853", adaptive_step),
        "tsit5": (TSIT5, "stages", adaptive_step),
        "bosh3": (BOSH3, "hermite", adaptive_step),
        "fehlberg2": (FEHLBERG2, "hermite", adaptive_step),
        "adaptive_heun": (ADAPTIVE_HEUN, "hermite", adaptive_step),
    }
    if method in table:
        return table[method]
    if method in ("sdirk4", "trbdf2"):
        from .dirk import DIRK_TABLEAUS, dirk_step

        return DIRK_TABLEAUS[method], "hermite", dirk_step
    raise ValueError(
        f"odeint_event needs an adaptive method with dense output, got "
        f"{method!r}; available: ['adaptive_heun', 'bosh3', 'dopri5', "
        "'dopri8', 'fehlberg2', 'sdirk4', 'trbdf2', 'tsit5']")


def _march_to_event(func, y0, t0, event_fn, tableau, interp_kind, cfg,
                    step_impl, t_max):
    """Step every system to its first accepted step whose end flips
    sign(g).  Returns (state, sign0, immediate, found, stats)."""
    state = init_adaptive_state(func, y0, t0, tableau, interp_kind, cfg)
    g = event_fn(state.t1, y0)
    sign0 = torch.sign(g)
    immediate = sign0 == 0
    while True:
        active = ((torch.sign(g) == sign0) & ~immediate
                  & (state.n_accepted + state.n_rejected < cfg.max_num_steps)
                  & can_step(state))
        if t_max is not None:
            active = active & (state.t1 < t_max)
        if not bool(active.any()):
            break
        state = select_state(active, step_impl(func, state, tableau,
                                               interp_kind, cfg), state)
        g = torch.where(active, event_fn(state.t1, state.y1), g)
    found = (torch.sign(g) != sign0) | immediate
    stats = {"nfe": state.nfe, "n_accepted": state.n_accepted,
             "n_rejected": state.n_rejected, "event_found": found}
    return state, sign0, immediate, found, stats


def _bisect_event(event_fn, interp_kind, state, sign0, n_iters):
    """Fixed-count bisection of g(t, interp(t)) on each system's crossing
    step [t0, t1], keeping sign(g(lo)) == sign0 != sign(g(hi))."""
    lo, hi = state.t0, state.t1
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        y_mid = evaluate_at(interp_kind, state.interp_coeff, state.t0,
                            state.t1, mid)
        before = torch.sign(event_fn(mid, y_mid)) == sign0
        lo, hi = torch.where(before, mid, lo), torch.where(before, hi, mid)
    return 0.5 * (lo + hi)


def odeint_event_with_stats(func: Callable, y0, t0, *, event_fn: Callable,
                            reverse_time: bool = False,
                            odeint_interface: Callable = odeint,
                            rtol: float = 1e-7, atol: float = 1e-9,
                            method: Optional[str] = None,
                            options: Optional[Dict[str, Any]] = None,
                            t_max=None, batched: bool = False):
    """`odeint_event` with the march's statistics nfe, n_accepted,
    n_rejected and event_found (per system when batched)."""
    method = method or "dopri5"
    options = dict(options or {})
    tableau, interp_kind, step_impl = method_triple(method)
    cfg = adaptive_config(rtol, atol, options)
    dev = tree_leaves(y0)[0].device
    t0 = torch.as_tensor(t0, dtype=torch.float64, device=dev)
    if t0.dim() != 0:
        raise ValueError(f"t0 must be a scalar, got shape {tuple(t0.shape)}")
    if batched:
        bfunc, by0, bevent = func, y0, event_fn
    else:
        bfunc, by0 = unbatch(func, y0)

        def bevent(t, y):
            g = torch.as_tensor(event_fn(t[0], tree_map(lambda l: l[0], y)))
            if g.dim() != 0:
                raise ValueError("event_fn must return a scalar, got "
                                 f"shape {tuple(g.shape)}")
            return g[None]
    B = tree_leaves(by0)[0].shape[0]
    # reverse time: march s = -t with the negated field and g(-s, y)
    if reverse_time:
        fwd_func = lambda s, y: tree_map(torch.neg, bfunc(-s, y))  # noqa
        fwd_event = lambda s, y: bevent(-s, y)  # noqa: E731
        fwd_t0 = -t0
    else:
        fwd_func, fwd_event, fwd_t0 = bfunc, bevent, t0
    fwd_t_max = None
    if t_max is not None:
        fwd_t_max = torch.as_tensor(t_max, dtype=torch.float64, device=dev)
        fwd_t_max = -fwd_t_max if reverse_time else fwd_t_max

    # 1-2. detect and localize, without a graph
    with torch.no_grad():
        y_sg = tree_map(lambda l: l.detach(), by0)
        state, sign0, immediate, found, stats = _march_to_event(
            fwd_func, y_sg, fwd_t0.expand(B), fwd_event, tableau,
            interp_kind, cfg, step_impl, fwd_t_max)
        n_iters = 60 if torch.finfo(t0.dtype).bits == 64 else 30
        t_star = _bisect_event(fwd_event, interp_kind, state, sign0, n_iters)
        t_star = torch.where(immediate, fwd_t0.expand(B),
                             torch.where(found, t_star, state.t1))
        t_sg = -t_star if reverse_time else t_star

    # 3. the differentiable re-solve and the IFT reroute, in user time
    ts = torch.stack([t0.expand(B), t_sg]) if batched \
        else torch.stack([t0, t_sg[0]])
    ys = odeint_interface(func, y0, ts, rtol=rtol, atol=atol, method=method,
                          options=options or None, batched=batched)
    y_star = tree_map(lambda a: a[-1], ys)
    t_b = t_sg if batched else t_sg[0]
    with torch.no_grad():
        f_sg = func(t_b, tree_map(lambda l: l.detach(), y_star))
    g_val = torch.as_tensor(event_fn(t_b, y_star))
    with torch.enable_grad():
        t_ = t_b.detach().requires_grad_(True)
        y_ = tree_map(lambda l: l.detach().requires_grad_(True), y_star)
        gg = torch.as_tensor(event_fn(t_, y_))
        grads = torch.autograd.grad(gg.sum(), [t_] + tree_leaves(y_),
                                    allow_unused=True)
    dg_dt = torch.zeros_like(t_b) if grads[0] is None else grads[0]
    for gy, f in zip(grads[1:], tree_leaves(f_sg)):
        if gy is not None:
            prod = (gy * f).to(dg_dt.dtype)
            dg_dt = dg_dt + (prod.reshape(B, -1).sum(1) if batched
                             else prod.sum())
    dg_dt = dg_dt.detach()
    safe = dg_dt.abs() > torch.finfo(dg_dt.dtype).tiny
    denom = torch.where(safe, dg_dt, torch.ones_like(dg_dt))
    g64 = g_val.to(dg_dt.dtype)
    shift = torch.where(safe, -g64 / denom, torch.zeros_like(g64))
    event_t = t_b + shift

    def polish(y, f):
        dtv = (event_t - t_b).to(y.dtype)
        return y + f * (dtv.reshape((-1,) + (1,) * (y.dim() - 1))
                        if batched else dtv)

    y_event = tree_map(polish, y_star, f_sg)
    found_u = found if batched else found[0]
    event_t = torch.where(found_u, event_t,
                          torch.full_like(event_t, float("nan")))
    ys = tree_map(lambda a, ye: torch.cat([a[:-1], ye.to(a.dtype)[None]]),
                  ys, y_event)
    if not batched:
        stats = {k: v[0] for k, v in stats.items()}
    return event_t, ys, stats


def odeint_event(func: Callable, y0, t0, *, event_fn: Callable,
                 reverse_time: bool = False,
                 odeint_interface: Callable = odeint, rtol: float = 1e-7,
                 atol: float = 1e-9, method: Optional[str] = None,
                 options: Optional[Dict[str, Any]] = None, t_max=None,
                 batched: bool = False):
    """Integrate until `event_fn(t, y)` first changes sign.  Returns
    (event_t, ys) with ys = [y(t0), y(event_t)], both differentiable in
    y0 and the tensors func and event_fn close over (through the
    implicit function theorem); event_t is NaN where no event occurs
    within the horizon (`t_max`, or the step budget
    options={"max_num_steps": ...})."""
    event_t, ys, _ = odeint_event_with_stats(
        func, y0, t0, event_fn=event_fn, reverse_time=reverse_time,
        odeint_interface=odeint_interface, rtol=rtol, atol=atol,
        method=method, options=options, t_max=t_max, batched=batched)
    return event_t, ys
