"""Diagonally-implicit Runge-Kutta stepping for stiff systems, batched.

Counterpart of `bayesian_ode_tpu/ode/dirk.py` ("sdirk4" and "trbdf2",
with cubic Hermite dense output), a drop-in `step_impl` of
`adaptive.integrate_adaptive`.  Each step of each system of the batch:

  - its n x n Jacobian at the step start, from n forward-mode JVPs over
    the whole batch (tangent e_j in every system at once; never the
    (B n)^2 Jacobian of the batched field), or from forward differences
    where the field is not traceable by `torch.func` (the continuous
    adjoint's augmented field, which calls `torch.autograd.grad`): it only
    preconditions the Newton iterations;
  - one batched LU of M = I - dt gamma J in the state's dtype, shared by
    every implicit stage;
  - `newton_iters` simplified-Newton iterations a stage, masked per
    system once its update's RMS (over atol + rtol |z|) falls to
    `newton_kappa`; a stage that does not converge forces a rejection
    (error ratio 1e6);
  - the embedded error raw, or filtered by M^-1 (error_filter="shampine").

The step mesh is data under autograd (dt and the error ratio are
detached), and each stage's derivative is the implicit-function
theorem's: the Newton iterations run without a graph and the converged
stage z is reattached through z - M_exact^-1 g(z), with M_exact the exact
stage Jacobian at z, whose value is z and whose derivative is the IFT's
(the JAX package's custom_root).

Both methods are stiffly accurate: y1 is the last stage and f(t1, y1) its
derivative, the FSAL slope and the Hermite output's endpoint slope.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch

from ..utils.pytree import ravel_batch
from .runge_kutta import AdaptiveState
from .step_control import error_ratio


class DIRKTableau(NamedTuple):
    """Diagonally-implicit RK tableau with embedded error weights.

    c:       stage times (all s stages).
    A:       s x s lower-triangular stage matrix (A[i][i] is 0 for an
             explicit first stage, gamma for the implicit ones).
    b:       solution weights (A's last row: stiffly accurate).
    b_error: b - b_hat.
    order:   the controller's exponent (both estimates are O(h^3)).
    gamma:   the shared implicit diagonal.
    """

    c: Sequence[float]
    A: Sequence[Sequence[float]]
    b: Sequence[float]
    b_error: Sequence[float]
    order: int
    gamma: float


# Hairer & Wanner, Solving ODEs II, Table IV.6.5: the L-stable 5-stage
# SDIRK of order 4, gamma = 1/4, with its order-3 embedded pair
SDIRK4 = DIRKTableau(
    c=[1 / 4, 3 / 4, 11 / 20, 1 / 2, 1.0],
    A=[
        [1 / 4, 0.0, 0.0, 0.0, 0.0],
        [1 / 2, 1 / 4, 0.0, 0.0, 0.0],
        [17 / 50, -1 / 25, 1 / 4, 0.0, 0.0],
        [371 / 1360, -137 / 2720, 15 / 544, 1 / 4, 0.0],
        [25 / 24, -49 / 48, 125 / 16, -85 / 12, 1 / 4],
    ],
    b=[25 / 24, -49 / 48, 125 / 16, -85 / 12, 1 / 4],
    b_error=[-3 / 16, -27 / 32, 25 / 32, 0.0, 1 / 4],
    order=3,
    gamma=1 / 4,
)

_SQRT2 = math.sqrt(2.0)
_D = 1.0 - _SQRT2 / 2.0

# TR-BDF2 as a 3-stage ESDIRK (Hosea & Shampine 1996): explicit first
# stage, L-stable, order 2 with an order-3 estimator; its implicit
# diagonal is 1 - sqrt(2)/2
TRBDF2 = DIRKTableau(
    c=[0.0, 2.0 - _SQRT2, 1.0],
    A=[
        [0.0, 0.0, 0.0],
        [_D, _D, 0.0],
        [_SQRT2 / 4.0, _SQRT2 / 4.0, _D],
    ],
    b=[_SQRT2 / 4.0, _SQRT2 / 4.0, _D],
    b_error=[
        _SQRT2 / 4.0 - (1.0 - _SQRT2 / 4.0) / 3.0,
        _SQRT2 / 4.0 - (3.0 * _SQRT2 / 4.0 + 1.0) / 3.0,
        _D - _D / 3.0,
    ],
    order=3,
    gamma=_D,
)

DIRK_TABLEAUS = {"sdirk4": SDIRK4, "trbdf2": TRBDF2}


def _jacobian(f, z):
    """(B, n, n) per-system Jacobian of f: (B, n) -> (B, n) at z, without
    a graph: n JVPs over the batch, or forward differences where f is not
    traceable by torch.func."""
    n = z.shape[1]
    eye = torch.eye(n, dtype=z.dtype, device=z.device)
    z = z.detach()
    with torch.no_grad():
        try:
            cols = [torch.func.jvp(f, (z,), (eye[j].expand_as(z),))[1]
                    for j in range(n)]
        except RuntimeError:
            f0 = f(z)
            h = torch.finfo(z.dtype).eps ** 0.5 * torch.clamp_min(z.abs(),
                                                                  1.0)
            cols = [(f(z + h[:, j:j + 1] * eye[j]) - f0) / h[:, j:j + 1]
                    for j in range(n)]
    return torch.stack(cols, dim=2)


def _solve(lu, v):
    return torch.linalg.lu_solve(*lu, v.unsqueeze(-1)).squeeze(-1)


def _newton_stage(f_vec, ti, r, a_dt, lu, z0, rtol, atol, iters, kappa):
    """z = r + a_dt f(ti, z) by `iters` simplified-Newton iterations a
    system, frozen once converged.  Returns (z, converged (B,))."""
    z = z0
    done = torch.zeros(z.shape[0], dtype=torch.bool, device=z.device)
    for _ in range(iters):
        g = z - a_dt * f_vec(ti, z) - r
        dz = _solve(lu, g)
        z_new = z - dz
        scale = atol + rtol * z_new.abs()
        eta = torch.sqrt(((dz / scale) ** 2).mean(dim=1))
        z = torch.where(done[:, None], z, z_new)
        done = done | (eta <= kappa)
    return z, done


def _implicit_stage(f_vec, ti, r, a_dt, lu, z0, rtol, atol, iters, kappa):
    """The Newton solve without a graph, reattached by the implicit
    function theorem: the returned z has the converged value and the
    derivative -M_exact^-1 dg of the stage residual g(z) = z - a_dt f(ti,
    z) - r."""
    with torch.no_grad():
        z, ok = _newton_stage(f_vec, ti.detach(), r.detach(), a_dt.detach(),
                              lu, z0.detach(), rtol, atol, iters, kappa)
    if not torch.is_grad_enabled():
        return z, ok
    g = z - a_dt * f_vec(ti, z) - r
    if not g.requires_grad:
        return z, ok
    with torch.no_grad():
        M = torch.eye(z.shape[1], dtype=z.dtype, device=z.device) \
            - a_dt[:, :, None] * _jacobian(lambda v: f_vec(ti.detach(), v),
                                           z)
    u = -torch.linalg.solve(M, g.unsqueeze(-1)).squeeze(-1)
    return z + (u - u.detach()), ok


def dirk_step(func: Callable, state: AdaptiveState, tableau: DIRKTableau,
              interp_kind: str, cfg) -> AdaptiveState:
    """One accept/reject DIRK step of every system (the signature of
    `adaptive.adaptive_step`): nfe n for the Jacobian plus newton_iters
    a implicit stage."""
    from .adaptive import INTERP, _where, next_dt

    if cfg.error_filter not in ("raw", "shampine"):
        raise ValueError(f"unknown error_filter {cfg.error_filter!r}; "
                         "expected 'raw' or 'shampine'")
    _, fit, _ = INTERP[interp_kind]
    y0, f0, t0 = state.y1, state.f1, state.t1
    dt = state.dt.detach()
    vec0, unravel = ravel_batch(y0)
    f0_vec, _ = ravel_batch(f0)
    n = vec0.shape[1]
    dtc = dt.to(vec0.dtype)[:, None]

    def f_vec(t, zv):
        return ravel_batch(func(t, unravel(zv)))[0]

    J = _jacobian(lambda zv: f_vec(t0.detach(), zv), vec0)
    M = torch.eye(n, dtype=vec0.dtype, device=vec0.device) \
        - (dtc * tableau.gamma)[:, :, None] * J
    lu = torch.linalg.lu_factor(M)

    ks = []
    converged = torch.ones(vec0.shape[0], dtype=torch.bool,
                           device=vec0.device)
    nfe_step = n
    for i in range(len(tableau.c)):
        row = tableau.A[i]
        ti = t0 + tableau.c[i] * dt
        r = vec0
        for j in range(i):
            if row[j] != 0.0:
                r = r + dtc * row[j] * ks[j]
        a_ii = row[i]
        if a_ii == 0.0:
            ki = f0_vec               # the explicit first stage: f(t0, y0)
        else:
            z0 = r + dtc * a_ii * (ks[i - 1] if i > 0 else f0_vec)
            z, ok = _implicit_stage(f_vec, ti, r, dtc * a_ii, lu, z0,
                                    cfg.rtol, cfg.atol, cfg.newton_iters,
                                    cfg.newton_kappa)
            converged = converged & ok
            ki = (z - r) / (dtc * a_ii)
            nfe_step += cfg.newton_iters
        ks.append(ki)

    y1_vec = vec0 + dtc * sum(b * k for b, k in zip(tableau.b, ks)
                              if b != 0.0)
    err_vec = dtc * sum(e * k for e, k in zip(tableau.b_error, ks)
                        if e != 0.0)
    if cfg.error_filter == "shampine":
        err_vec = _solve(lu, err_vec)
    y1, f1, y1_error = unravel(y1_vec), unravel(ks[-1]), unravel(err_vec)
    floor = cfg.ulp_floor if cfg.ulp_floor is not None else 32.0
    ratio = error_ratio(y1_error, cfg.rtol, cfg.atol, y0, y1, floor,
                        cfg.norm_weights).detach()
    ratio = torch.where(converged, ratio, torch.full_like(ratio, 1e6))
    accept = ratio <= 1.0
    coeff = _where(accept, fit(func, tableau, y0, y1, [f0, f1], t0, dt),
                   state.interp_coeff)
    dt_next, err_prev = next_dt(dt, ratio, state, accept, cfg,
                                tableau.order)
    return AdaptiveState(
        y1=_where(accept, y1, y0), f1=_where(accept, f1, f0), t0=t0,
        t1=torch.where(accept, t0 + dt, t0), dt=dt_next, interp_coeff=coeff,
        nfe=state.nfe + nfe_step,
        n_accepted=state.n_accepted + accept.to(state.n_accepted.dtype),
        n_rejected=state.n_rejected + (~accept).to(state.n_rejected.dtype),
        comp=state.comp, err_prev=err_prev)
