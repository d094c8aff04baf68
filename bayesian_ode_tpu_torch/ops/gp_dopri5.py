"""Whole adaptive dopri5 solves of the GP field for a batch of chains.

Counterpart of `bayesian_ode_tpu/ops/gp_dopri5.py`.  The step arithmetic
(`_make_rhs`, `_rk_stages`, `_step_decision`, `_quartic_coeffs`,
`_midpoint`, each over a tableau) and the Hairer start step live here once
as torch functions for the plain versions of every field, and once as
CUDA device functions in `csrc/dopri5_common.cuh` for the kernels, in the
same operation order.

`gp_dopri5_solve_whole` is the GP registration of the public engine
(`ops/gp_field.py`) solved without records: kernel K1 (replacing the TPU
kernel `_make_whole_kernel`) for CUDA tensors, its plain version for CPU
tensors.  Per-state tensors are (C, N, 2) and per-chain scalars (C,), all
float32 inside the solve; time is float32 too.

Not ported yet: the per-step solver `gp_dopri5_solve` (K9, ROADMAP).
"""
from __future__ import annotations

import torch

from ..ode.interp import interp_fit
from ..ode.tableaus import DOPRI5

_ULPS = 32.0                    # tolerance floor, as ode/step_control
_EPS_F32 = 2.0 ** -23         # float32 machine epsilon, exactly
# The JAX kernels floor the error norms at float32(1e-38), a subnormal
# that XLA flushes to zero; the floor is therefore 0 here, so a step whose
# error estimate is exactly 0 leaves 0 in the PI memory as it does there.
_NORM_FLOOR = 0.0


def _make_rhs(A, Z, sf: float, ell: float):
    """GP field at the N points of every chain in the direct form the kernel
    uses: f_n = sum_m sf^2 exp(-((x_n - z_m)^2 + (y_n - z_m)^2) / 2ell^2) A_m.
    A (C, M, 2), Z (M, 2); rhs maps (C, N, 2) -> (C, N, 2)."""
    sf2 = sf * sf
    inv2ell2 = 0.5 / (ell * ell)

    def rhs(y):
        d = y[:, :, None, :] - Z                       # (C, N, M, 2)
        K = sf2 * torch.exp(-(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                            * inv2ell2)                # (C, N, M)
        f = K[:, :, 0, None] * A[:, None, 0]
        for m in range(1, A.shape[1]):                 # in order, as the kernel
            f = f + K[:, :, m, None] * A[:, None, m]
        return f

    return rhs


def _make_rhs_vjp(A, Z, sf: float, ell: float):
    """VJP of the GP field: (y, cot) -> (ybar (C, N, 2), Abar (C, M, 2))."""
    sf2 = sf * sf
    inv2ell2 = 0.5 / (ell * ell)
    invell2 = 1.0 / (ell * ell)

    def rhs_vjp(y, cot):
        d = y[:, :, None, :] - Z                       # (C, N, M, 2)
        K = sf2 * torch.exp(-(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                            * inv2ell2)                # (C, N, M)
        Abar = (K[..., None] * cot[:, :, None, :]).sum(dim=1)
        adotc = (A[:, None] * cot[:, :, None, :]).sum(dim=-1)
        w = K * adotc * invell2
        ybar = (w[..., None] * (-d)).sum(dim=2)
        return ybar, Abar

    return rhs_vjp


def _bc(x):
    """Per-chain scalar (C,) -> (C, 1, 1), against (C, N, 2) states."""
    return x[:, None, None]


def _rk_stages(rhs, y0, f0, dt, tableau=DOPRI5):
    """Stages of the 7-stage FSAL pair.  Returns (k, y1): k[0] = f0 and
    k[6] = f(y1), y1 the last stage point."""
    k = [f0]
    dtc = _bc(dt)
    s = y0
    for beta_i in tableau.beta:
        inc = sum(b * kk for b, kk in zip(beta_i, k) if b != 0)
        s = y0 + dtc * inc
        k.append(rhs(s))
    return k, s


def _step_decision(k, y0, y1, dt, rtol, atol, safety, ifactor, dfactor,
                   err_prev=None, tableau=DOPRI5):
    """Embedded error ratio (mean square over the 2N components with the
    32-ulps tolerance floor) and the step controller.  Returns
    (accept, ratio, dt_next, err_next), all (C,).

    err_prev None -> the memoryless "i" controller (err_next None);
    err_prev (C,) -> the Gustafsson PI.4.2 controller."""
    err = _bc(dt) * sum(c * kk for c, kk in zip(tableau.c_error, k) if c != 0)
    mag = torch.maximum(y0.abs(), y1.abs())
    tol = torch.maximum(atol + rtol * mag, (_ULPS * _EPS_F32) * mag)
    r2 = (err / tol) ** 2
    N = y0.shape[1]
    ratio = (r2[..., 0].sum(dim=1) + r2[..., 1].sum(dim=1)) / (2 * N)
    accept = ratio <= 1.0

    order = tableau.order
    err_nrm = torch.sqrt(torch.clamp_min(ratio, _NORM_FLOOR))
    one = torch.ones_like(ratio)
    dfac = torch.where(ratio < 1.0, one, one * dfactor)
    factor = torch.maximum(
        one * (1.0 / ifactor),
        torch.minimum(err_nrm ** (1.0 / order) / safety, 1.0 / dfac))
    factor = torch.where(torch.isfinite(factor), factor, 1.0 / dfac)
    dt_i = dt / factor
    if err_prev is None:
        return accept, ratio, torch.where(ratio == 0.0, dt * ifactor, dt_i), \
            None
    beta1, beta2 = 0.6, -0.2                      # Soderlind PI.4.2
    ep = torch.clamp_min(err_prev, _NORM_FLOOR)
    factor_acc = (safety * err_nrm ** (-beta1 / order)
                  * ep ** (-beta2 / order))
    factor_acc = torch.where(torch.isfinite(factor_acc), factor_acc,
                             one * dfactor)
    dt_acc = dt * torch.clamp(factor_acc, dfactor, ifactor)
    dt_next = torch.where(accept, dt_acc, dt_i)
    dt_next = torch.where(ratio == 0.0, dt * ifactor, dt_next)
    err_next = torch.where(accept, err_nrm, err_prev)
    return accept, ratio, dt_next, err_next


# Dense-output quartic fit, highest order first: (y0, y1, ymid, f0, f1, dt)
# -> (a, b, c, d, e), dt broadcasting against the states.
_quartic_coeffs = interp_fit


def _midpoint(y0, k, dt, tableau=DOPRI5):
    return y0 + _bc(dt) * sum(c * kk for c, kk in zip(tableau.c_mid, k)
                              if c != 0)


def _hairer_initial_step(rhs_ref, pts0, rtol, atol):
    """Hairer-style first step over batched (C, N, 2) states.  Returns
    (f0 (C, N, 2), dt0 (C,) float32)."""
    f0 = rhs_ref(pts0)
    scale = atol + pts0.abs() * rtol
    d0 = torch.sqrt(((pts0 / scale) ** 2).mean(dim=(1, 2)))
    d1 = torch.sqrt(((f0 / scale) ** 2).mean(dim=(1, 2)))
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6),
                     0.01 * d0 / torch.clamp_min(d1, 1e-30))
    p1 = pts0 + _bc(h0) * f0
    f1 = rhs_ref(p1)
    d2 = torch.sqrt((((f1 - f0) / scale) ** 2).mean(dim=(1, 2))) / h0
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15),
                     torch.clamp_min(h0 * 1e-3, 1e-6),
                     (0.01 / torch.clamp_min(torch.maximum(d1, d2), 1e-30))
                     ** (1.0 / 5.0))
    dt0 = torch.minimum(100 * h0, h1).to(torch.float32)
    return f0, dt0


def _pack_initial(A, x0, Z, sf, ell, rtol, atol):
    """Host part of the GP solve set-up: the (C, N, 2) start states and
    the Hairer initial slope and step.  The initial slope uses `rbf`'s
    matmul form, as the JAX package does (the kernels use the direct
    form).  Returns (x0b, f0, dt0)."""
    from .fused_field import _start
    from .gp_field import gp_field

    return _start(gp_field(float(sf), float(ell)), (A, Z),
                  x0.to(torch.float32), rtol, atol)


def _check_controller(controller):
    if controller not in ("i", "pi"):
        raise ValueError(
            f"unknown step controller {controller!r}; expected 'i' "
            "(reference parity) or 'pi' (Gustafsson)")


def gp_dopri5_solve_whole(A, x0, ts, static, rtol=1e-7, atol=1e-9,
                          safety=0.9, ifactor=10.0, dfactor=0.2,
                          max_steps=100_000, controller="i"):
    """Adaptive dopri5 solve of the GP field for C chains, one whole solve
    per chain with its own step sizes.

    A (C, M, 2) per-chain weights (Kzz^{-1} L U), x0 (N, 2) shared, ts (T,)
    increasing, static a `GPVectorFieldStatic` (Z, sf, ell are read).
    Returns (ys (T, C, N, 2), stats) with per-chain int32 nfe /
    n_accepted / n_rejected / n_iterations and the bool
    reached_final_time.  The budget `max_steps` is per chain; output times
    a chain never reached hold its final state.  controller "i" is the
    reference's memoryless controller, "pi" the Gustafsson PI controller.

    CUDA tensors launch kernel K1; CPU tensors take the plain version.
    """
    from .fused_field import fused_dopri5_stats
    from .gp_field import gp_field, gp_weights

    return fused_dopri5_stats(
        gp_field(float(static.sf), float(static.ell)), gp_weights(A, static),
        x0, ts, rtol=rtol, atol=atol, safety=safety, ifactor=ifactor,
        dfactor=dfactor, max_steps=max_steps, controller=controller)


def gp_dopri5_solve_whole_plain(A, x0, ts, static, rtol=1e-7, atol=1e-9,
                                safety=0.9, ifactor=10.0, dfactor=0.2,
                                max_steps=100_000, controller="i"):
    """The plain PyTorch version of `gp_dopri5_solve_whole`, on any
    device: the chains advance in masked lockstep."""
    from .fused_field import fused_dopri5_stats_plain
    from .gp_field import gp_field, gp_weights

    return fused_dopri5_stats_plain(
        gp_field(float(static.sf), float(static.ell)), gp_weights(A, static),
        x0, ts, rtol=rtol, atol=atol, safety=safety, ifactor=ifactor,
        dfactor=dfactor, max_steps=max_steps, controller=controller)
