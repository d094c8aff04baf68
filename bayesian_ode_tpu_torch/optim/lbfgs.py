"""L-BFGS with curvature-pair rejection / Powell damping and Armijo /
weak-Wolfe line searches.

Counterpart of `bayesian_ode_tpu/optim/lbfgs.py` (the reference's
optims/LBFGS.py, a minFunc port).  The history is a fixed-shape buffer
(oldest first) with a validity mask, as in the JAX package; its bounded
`lax.while_loop` line searches are Python loops with the same `max_ls`
bound and exit tests, reading their scalars on the host.

  - two-loop recursion with H_diag = y's/y'y initial scaling;
  - curvature rejection y's > eps s'Bs, or Powell damping
    y <- theta y + (1 - theta) Bs, theta = (1 - eps) s'Bs / (s'Bs - y's),
    with Bs approximated by -t g;
  - Armijo backtracking with the minFunc interpolation ladder (quadratic,
    then the 3-point cubic, `optim/polyinterp.py`); weak-Wolfe bracketing
    with eta-expansion and the safeguarded cubic inside the bracket;
  - a move that is not finite, or does not improve the value after a
    failed search, is rejected: the position holds and the next search
    restarts from a quarter of the last trial step (so an ODE posterior's
    inf cliff next to the iterate cannot poison the history).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.pytree import ravel_pytree
from . import polyinterp


class LBFGSState(NamedTuple):
    position: torch.Tensor   # flat (P,)
    value: torch.Tensor
    grad: torch.Tensor       # flat (P,)
    s_buf: torch.Tensor      # (m, P) parameter differences, oldest first
    y_buf: torch.Tensor      # (m, P) gradient differences
    valid: torch.Tensor      # (m,) bool
    h_diag: torch.Tensor     # initial Hessian scaling
    prev_grad: torch.Tensor
    t: torch.Tensor          # last step length
    d: torch.Tensor          # last search direction
    fail: bool               # the last line search failed or was rejected
    n_iter: int
    curv_skips: int
    fail_skips: int


def _dot(a, b):
    return (a * b).sum()


def two_loop_recursion(state: LBFGSState, vec: torch.Tensor) -> torch.Tensor:
    """H @ vec from the (s, y) history; masked slots are skipped."""
    m = state.s_buf.shape[0]
    q = vec
    alphas = {}
    for i in range(m - 1, -1, -1):
        s, y, ok = state.s_buf[i], state.y_buf[i], state.valid[i]
        rho = 1.0 / torch.where(ok, _dot(s, y), 1.0)
        a = torch.where(ok, rho * _dot(s, q), 0.0)
        q = q - a * y
        alphas[i] = a
    r = q * state.h_diag
    for i in range(m):
        s, y, ok = state.s_buf[i], state.y_buf[i], state.valid[i]
        rho = 1.0 / torch.where(ok, _dot(s, y), 1.0)
        beta = torch.where(ok, rho * _dot(y, r), 0.0)
        r = r + (alphas[i] - beta) * s
    return r


def _shift_in(buf, row):
    return torch.cat([buf[1:], row[None]])


def curvature_update(state: LBFGSState, flat_grad: torch.Tensor,
                     eps: float = 1e-2, damping: bool = False) -> LBFGSState:
    """Insert (s, y) = (t d, grad - prev_grad) with rejection or damping.
    No-op on the first iteration and after a failed line search."""
    s = state.d * state.t
    y = flat_grad - state.prev_grad
    Bs = -state.t * state.prev_grad
    sBs = _dot(s, Bs)
    ys = _dot(y, s)

    can_update = state.n_iter > 0 and not state.fail
    accept = bool(ys > eps * sBs)
    if damping:
        if not accept:
            theta = ((1 - eps) * sBs) / torch.where(sBs == ys, 1.0, sBs - ys)
            y = theta * y + (1 - theta) * Bs
        accept = True

    state = state._replace(
        curv_skips=state.curv_skips + int(can_update and not accept),
        fail_skips=state.fail_skips + int(state.n_iter > 0 and state.fail))
    if not (can_update and accept):
        return state
    return state._replace(
        s_buf=_shift_in(state.s_buf, s), y_buf=_shift_in(state.y_buf, y),
        valid=_shift_in(state.valid, torch.ones((), dtype=torch.bool,
                                                device=s.device)),
        h_diag=_dot(y, s) / torch.clamp(_dot(y, y), min=1e-300))


def _armijo_search(fn, x, d, F0, gtd, t0, c1, eta, max_ls, interpolate):
    """Backtracking: shrink t until F(x + t d) <= F0 + c1 t gtd.  Each
    backtrack takes the quadratic through (0, F0, gtd), (t, F_new) while no
    earlier trial is finite, then the cubic through those and the previous
    trial, safeguarded into [1e-3 t, 0.6 t]; t / eta after a non-finite
    trial.  Returns (t, F_new, trials, failed)."""
    zero = torch.zeros_like(t0)
    t, t_prev = t0, zero
    F_new = fn(x + t0 * d)
    F_prev = torch.full_like(F0, float("nan"))
    ls, done = 1, bool(F_new <= F0 + c1 * t0 * gtd)
    while not done and ls < max_ls:
        if interpolate and ls != 0 and bool(torch.isfinite(F_new)):
            if ls == 1 or not bool(torch.isfinite(F_prev)):
                t_i = polyinterp.quad_min(zero, F0, gtd, t, F_new, zero, t)
            else:
                t_i = polyinterp.cubic_min_3pt(
                    zero, F0, gtd, t, F_new, t_prev, F_prev, zero,
                    torch.maximum(t, t_prev))
            t_new = torch.minimum(torch.maximum(t_i, 1e-3 * t), 0.6 * t)
        else:
            t_new = t / eta
        F_try = fn(x + t_new * d)
        done = bool(F_try <= F0 + c1 * t_new * gtd)
        t, t_prev, F_new, F_prev, ls = t_new, t, F_try, F_new, ls + 1
    return t, F_new, ls, not done


def _wolfe_search(value_and_grad, x, d, F0, gtd, t0, c1, c2, eta, max_ls,
                  interpolate=True):
    """Weak Wolfe bracketing: sufficient decrease and curvature
    gtd_new >= c2 gtd.  A failed Armijo test sets the upper bound beta = t,
    a failed curvature test the lower bound alpha = t; the next t is eta t
    while unbracketed, else the cubic minimizer over (alpha, beta) clamped
    into [alpha + 0.2 (beta - alpha), (alpha + beta) / 2] (the JAX
    package's two documented deviations from the reference).  Returns
    (t, F_new, trials, failed)."""
    def eval_t(t):
        F, g = value_and_grad(x + t * d)
        return F, _dot(g, d)

    alpha = torch.zeros_like(t0)
    beta = torch.full_like(t0, float("inf"))
    nan = torch.full_like(F0, float("nan"))
    F_a, g_a, F_b, g_b = F0, gtd, nan, nan
    t = t0
    F_new, gtd_new = eval_t(t0)
    ls, done = 0, False
    while not done and ls < max_ls:
        armijo = bool(F_new <= F0 + c1 * t * gtd)
        curv = bool(gtd_new >= c2 * gtd)
        done = armijo and curv
        ls += 1
        if done:
            break
        if not armijo:
            beta, F_b, g_b = t, F_new, gtd_new
        else:
            alpha, F_a, g_a = t, F_new, gtd_new
        if bool(torch.isfinite(F_b) & torch.isfinite(beta)):
            if interpolate:
                t_i = polyinterp.cubic_min(alpha, F_a, g_a, beta, F_b, g_b,
                                           alpha, beta)
                width = beta - alpha
                t = torch.minimum(torch.maximum(t_i, alpha + 0.2 * width),
                                  alpha + 0.5 * width)
            else:
                t = 0.5 * (alpha + beta)
        elif bool(torch.isfinite(beta)):
            t = 0.5 * (alpha + beta)
        else:
            t = t * eta
        F_new, gtd_new = eval_t(t)
    return t, F_new, ls, not done


def lbfgs_init(fn_value_and_grad: Callable, position,
               history_size: int = 10) -> tuple:
    """Returns (state, unravel).  `fn_value_and_grad(flat_x) -> (F, g)`."""
    vec, unravel = ravel_pytree(position)
    F, g = fn_value_and_grad(vec)
    P = vec.shape[0]
    z = torch.zeros((history_size, P), dtype=vec.dtype, device=vec.device)
    state = LBFGSState(
        position=vec, value=F, grad=g, s_buf=z, y_buf=z,
        valid=torch.zeros((history_size,), dtype=torch.bool,
                          device=vec.device),
        h_diag=torch.ones((), dtype=vec.dtype, device=vec.device),
        prev_grad=g, t=torch.ones((), dtype=vec.dtype, device=vec.device),
        d=torch.zeros_like(vec), fail=False, n_iter=0, curv_skips=0,
        fail_skips=0)
    return state, unravel


def lbfgs_step(fn_value_and_grad: Callable, state: LBFGSState,
               lr: float = 1.0, line_search: str = "wolfe",
               c1: float = 1e-4, c2: float = 0.9, eta: float = 2.0,
               max_ls: int = 10, eps: float = 1e-2, damping: bool = False,
               interpolate: bool = True,
               fn_value: Optional[Callable] = None) -> LBFGSState:
    """One full L-BFGS iteration: curvature update, two-loop direction,
    line search, move.  `fn_value(flat_x) -> F`, where given, evaluates
    the Armijo and fixed-step trials without a gradient."""
    state = curvature_update(state, state.grad, eps=eps, damping=damping)
    d = two_loop_recursion(state, -state.grad)
    gtd = _dot(state.grad, d)
    # fall back to steepest descent if not a descent direction
    if not bool(gtd < 0):
        d = -state.grad
        gtd = -_dot(state.grad, state.grad)

    # after a failed or rejected step, restart from a quarter of the last
    # trial step: consecutive failures shrink it geometrically
    if state.fail:
        t0 = torch.clamp(0.25 * state.t, min=1e-10, max=lr)
    else:
        t0 = torch.full_like(state.t, lr)
    fn = fn_value or (lambda x: fn_value_and_grad(x)[0])
    if line_search == "none":
        t, fail = t0, False
    elif line_search == "armijo":
        t, _, _, fail = _armijo_search(fn, state.position, d, state.value,
                                       gtd, t0, c1, eta, max_ls, interpolate)
    elif line_search == "wolfe":
        t, _, _, fail = _wolfe_search(fn_value_and_grad, state.position, d,
                                      state.value, gtd, t0, c1, c2, eta,
                                      max_ls, interpolate)
    else:
        raise ValueError(f"unknown line_search {line_search!r}")

    new_pos = state.position + t * d
    F, g = fn_value_and_grad(new_pos)
    # reject the move unless it is finite and (the search succeeded or the
    # value strictly improved); a rejected move holds the position
    accept = bool(torch.isfinite(F)) and (not fail or bool(F < state.value))
    if not accept:
        new_pos, F, g = state.position, state.value, state.grad
    return state._replace(
        position=new_pos, value=F, grad=g, prev_grad=state.grad, t=t, d=d,
        fail=fail or not accept, n_iter=state.n_iter + 1)


def lbfgs_minimize(fn: Callable, position, max_iters: int = 100,
                   history_size: int = 10, lr: float = 1.0,
                   line_search: str = "wolfe", **kwargs):
    """MAP optimization: `lbfgs_step` for `max_iters` iterations.

    `fn(tree) -> scalar`.  Returns (final position tree, final value,
    (max_iters,) trace of the value after each iteration, final state).
    """
    _, unravel = ravel_pytree(position)

    def vg(v):
        with torch.enable_grad():
            v = v.detach().requires_grad_(True)
            F = fn(unravel(v))
            (g,) = torch.autograd.grad(F, v)
        return F.detach(), g

    def value(v):
        with torch.no_grad():
            return fn(unravel(v))

    state, _ = lbfgs_init(vg, position, history_size)
    values = []
    for _ in range(max_iters):
        state = lbfgs_step(vg, state, lr=lr, line_search=line_search,
                           fn_value=value, **kwargs)
        values.append(state.value)
    return unravel(state.position), state.value, torch.stack(values), state
