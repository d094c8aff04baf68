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

`gp_dopri5_solve` is the per-step solver: a host loop per output interval
launches kernel K9 (`csrc/gp_dopri5_step.cu`, replacing the TPU kernel
`_make_kernel`) until every chain has passed the output time, then
evaluates the dense output there (`_interp_eval`).  Its step budget is
collective, as in the JAX package; prefer `gp_dopri5_solve_whole`.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import NamedTuple

import torch

from ..ode.interp import interp_evaluate, interp_fit
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


# ---------------------------------------------------------------------------
# the per-step solver: K9 and its plain version
# ---------------------------------------------------------------------------

class GPDopri5State(NamedTuple):
    """The per-step solver's state between launches (the counterpart of the
    JAX package's lane-major `GPDopri5State`)."""
    y: torch.Tensor      # (C, N, 2) state at t1
    f: torch.Tensor      # (C, N, 2) FSAL slope at t1
    t0: torch.Tensor     # (C,) start of the last accepted step
    t1: torch.Tensor     # (C,) its end
    dt: torch.Tensor     # (C,) proposed next step
    coef: torch.Tensor   # (5, C, N, 2) quartic of the last accepted step
    nfe: torch.Tensor    # (C,) int32
    nacc: torch.Tensor
    nrej: torch.Tensor


def _interp_eval(state: GPDopri5State, t):
    """The dense-output quartic of each chain's last accepted step at the
    time t: (C, N, 2), at x = (t - t0) / (t1 - t0), 0 where t1 == t0."""
    return interp_evaluate(list(state.coef), _bc(state.t0), _bc(state.t1), t)


def _step_init(w, x0, ts, static, rtol, atol):
    """The state at ts[0]: nfe 2 (the Hairer start step's two evaluations)
    and the quartic's constant row e = x0, as the JAX package starts."""
    A, Z = w
    C = A.shape[0]
    if C % 128 != 0:
        raise ValueError(f"chain count must be a multiple of 128, got {C}")
    x0b, f0, dt0 = _pack_initial(A, x0, Z, static.sf, static.ell, rtol, atol)
    y = x0b.contiguous()
    coef = torch.zeros((5,) + y.shape, dtype=torch.float32, device=A.device)
    coef[4] = y
    t0 = ts[0].expand(C).contiguous()
    i32 = dict(dtype=torch.int32, device=A.device)
    return GPDopri5State(
        y=y.clone(), f=f0.contiguous(), t0=t0, t1=t0.clone(),
        dt=dt0.contiguous(), coef=coef, nfe=torch.full((C,), 2, **i32),
        nacc=torch.zeros(C, **i32), nrej=torch.zeros(C, **i32))


def _step_plain(state, ts, k, rhs, steps, rtol, atol, safety, ifactor,
                dfactor):
    """Plain version of one launch of K9: up to `steps` masked steps of
    every chain with t1 < ts[k].  Returns (state, pending, taken): the
    least first output index m with ts[m] > t1 over the chains, and the
    most steps any chain has taken."""
    y, f, t0, t1, dt, coef, nfe, nacc, nrej = state
    next_t = ts[k]
    for _ in range(steps):
        active = t1 < next_t
        kk, y1 = _rk_stages(rhs, y, f, dt)
        accept, _, dt_next, _ = _step_decision(kk, y, y1, dt, rtol, atol,
                                               safety, ifactor, dfactor)
        ym = _midpoint(y, kk, dt)
        cf = torch.stack(_quartic_coeffs(y, y1, ym, f, kk[6], _bc(dt)))
        take = active & accept
        sel = _bc(take)
        coef = torch.where(sel, cf, coef)
        y = torch.where(sel, y1, y)
        f = torch.where(sel, kk[6], f)
        t0 = torch.where(take, t1, t0)
        t1 = torch.where(take, t1 + dt, t1)
        dt = torch.where(active, dt_next, dt)
        nfe = nfe + 6 * active.int()
        nacc = nacc + take.int()
        nrej = nrej + (active & ~accept).int()
    pending = int(torch.searchsorted(ts, t1, right=True).min())
    state = GPDopri5State(y, f, t0, t1, dt, coef, nfe, nacc, nrej)
    return state, pending, int((nacc + nrej).max())


def _step_launch(state, ts, k, lib, w, scalars, flags, steps, rtol, atol,
                 safety, ifactor, dfactor):
    """One launch of K9, updating `state` in place; returns (state,
    pending, taken) read back from the kernel's flags (the launch's one
    device-to-host read)."""
    from . import _build
    from .fused_adaptive import _stream

    A, Z = w
    dev = A.device
    with torch.cuda.device(dev):
        status = lib.gp_dopri5_step(
            A.data_ptr(), Z.data_ptr(), *scalars, ts.data_ptr(), k,
            ts.shape[0], A.shape[0], steps, rtol, atol, safety, ifactor,
            dfactor, *(x.data_ptr() for x in state), flags.data_ptr(),
            _stream(dev))
    _build.check(status, "gp_dopri5_step")
    _build.launch_counts["gp_dopri5_step"] += 1
    pending, taken = flags.tolist()
    return state, pending, taken


def _solve_steps(state, ts, max_steps, advance):
    """The host loop of the per-step solver: per output interval k,
    advance while a chain is short of ts[k] and no chain has used the
    budget (collective), then evaluate the dense output at ts[k]."""
    times = ts.tolist()
    pending = bisect_right(times, times[0])   # every chain starts at ts[0]
    taken = 0
    ys = [state.y.clone()]
    for k in range(1, len(times)):
        while pending <= k and taken < max_steps:
            state, pending, taken = advance(state, k)
        ys.append(_interp_eval(state, ts[k]))
    stats = {"nfe": state.nfe, "n_accepted": state.nacc,
             "n_rejected": state.nrej,
             "reached_final_time": bool((state.t1 >= ts[-1]).all())}
    return torch.stack(ys), stats


def gp_dopri5_solve(A, x0, ts, static, rtol=1e-7, atol=1e-9, safety=0.9,
                    ifactor=10.0, dfactor=0.2, max_steps=100_000,
                    steps_per_call=1):
    """Solve the GP-field ODE for C chains with the per-step solver.

    A (C, M, 2) per-chain weights (Kzz^{-1} L U), x0 (N, 2) shared, ts (T,)
    output times, static a `GPVectorFieldStatic`.  Returns (ys (T, C, N, 2),
    stats) with per-chain int32 nfe / n_accepted / n_rejected and the bool
    reached_final_time.  C must be a multiple of 128, as in the JAX
    package.

    A host loop per output interval launches kernel K9 (CUDA tensors; one
    small device-to-host read per launch decides the next) or runs its
    plain version (CPU tensors), `steps_per_call` masked steps a launch,
    while any chain is short of the output time; then the dense output is
    evaluated there.  The budget `max_steps` is collective: once any chain
    has taken that many steps, the whole batch stops for the interval
    (see reached_final_time).  The whole-solve kernel
    (`gp_dopri5_solve_whole`) takes the same steps with a per-chain budget
    and no host loop; prefer it.
    """
    if not A.is_cuda:
        if A.device.type != "cpu":
            raise ValueError(f"unsupported device {A.device}")
        return gp_dopri5_solve_plain(A, x0, ts, static, rtol, atol, safety,
                                     ifactor, dfactor, max_steps,
                                     steps_per_call)
    from . import _build
    from .fused_adaptive import _check_args, _check_weights
    from .fused_field import _prepare
    from .gp_field import gp_field, gp_weights

    w, x0, ts = _prepare(gp_weights(A, static), x0, ts)
    field = gp_field(float(static.sf), float(static.ell))
    M, N, T = w[0].shape[1], x0.shape[0], ts.shape[0]
    _check_weights(field, w)
    _check_args(w[0].device, ts=(ts, (T,), torch.float32))
    if not 0 < steps_per_call < 2**31:
        raise ValueError(f"steps_per_call must be a positive int32, got "
                         f"{steps_per_call}")
    with torch.no_grad():
        state = _step_init(w, x0, ts, static, rtol, atol)
    lib = _build.load_library("gp_dopri5_step", (N, M))
    flags = torch.empty(2, dtype=torch.int32, device=ts.device)

    def advance(state, k):
        return _step_launch(state, ts, k, lib, w, field.scalars, flags,
                            int(steps_per_call), rtol, atol, safety, ifactor,
                            dfactor)

    return _solve_steps(state, ts, max_steps, advance)


def gp_dopri5_solve_plain(A, x0, ts, static, rtol=1e-7, atol=1e-9,
                          safety=0.9, ifactor=10.0, dfactor=0.2,
                          max_steps=100_000, steps_per_call=1):
    """The plain PyTorch version of `gp_dopri5_solve`, on any device: the
    same host loop over the plain version of K9's masked steps."""
    from .fused_field import _prepare
    from .gp_field import gp_weights

    w, x0, ts = _prepare(gp_weights(A, static), x0, ts)
    with torch.no_grad():
        state = _step_init(w, x0, ts, static, rtol, atol)
        rhs = _make_rhs(*w, float(static.sf), float(static.ell))

        def advance(state, k):
            return _step_plain(state, ts, k, rhs, int(steps_per_call), rtol,
                               atol, safety, ifactor, dfactor)

        return _solve_steps(state, ts, max_steps, advance)
