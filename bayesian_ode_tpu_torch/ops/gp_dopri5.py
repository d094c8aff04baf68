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

`gp_dopri5_solve` is the per-step solver: one launch of kernel K9
(`csrc/gp_dopri5_step.cu`, replacing the TPU kernel `_make_kernel` and
the JAX loop around it) per output interval takes every chain to the
output time and writes its dense output there.  The launches are issued
at once, each capped on the device by the budget left after the one
before, and the host reads their flags once a solve; only where the
budget left a chain short of an output time with steps to spare does it
run the solve again launch by launch.  Its step budget is collective, as
in the JAX package; prefer `gp_dopri5_solve_whole`.
"""
from __future__ import annotations

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
    time t: (C, N, 2), at x = (t - t0) / (t1 - t0), 0 where t1 == t0.  K9
    evaluates it in the same order of operations (csrc/dopri5_kernels.cuh,
    dense_output)."""
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


def _interval_plain(state, ys, ts, k, cap, rhs, rtol, atol, safety,
                    ifactor, dfactor):
    """Plain version of one launch of K9 for output interval k: masked
    lockstep steps of every chain with t1 < ts[k], at most `cap` of them,
    then the dense output at ts[k] into ys[k].  Returns (state, short,
    taken): whether a chain is still short of ts[k], and the most steps
    any chain has taken."""
    y, f, t0, t1, dt, coef, nfe, nacc, nrej = state
    next_t = ts[k]
    for _ in range(cap):
        active = t1 < next_t
        if not bool(active.any()):
            break
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
    state = GPDopri5State(y, f, t0, t1, dt, coef, nfe, nacc, nrej)
    ys[k] = _interp_eval(state, next_t)
    return state, bool((t1 < next_t).any()), int((nacc + nrej).max())


def _intervals_plain(state, ys, ts, max_steps, steps_per_call, rhs, *ctrl):
    """Plain version of K9's launches of all output intervals at once: one
    `_interval_plain` per interval k, capped by the budget left after the
    one before.  Returns (state, flags): flags[k] = (short, taken) of
    interval k's launch, flags[0] = (0, 0)."""
    flags, taken = [(0, 0)], 0
    for k in range(1, ts.shape[0]):
        state, short, taken = _interval_plain(
            state, ys, ts, k, _cap(max_steps - taken, steps_per_call), rhs,
            *ctrl)
        flags.append((int(short), taken))
    return state, flags


def _intervals_launch(state, ys, ts, max_steps, steps_per_call, lib, w,
                      scalars, flags, *ctrl):
    """K9's launches of all output intervals at once (one C call, T - 1
    launches, each reading its cap from the flags of the one before), and
    the solve's one read of their flags: (state, flags) as
    `_intervals_plain` returns them; `state` and ys updated in place."""
    from . import _build
    from .fused_adaptive import _stream

    A, Z = w
    dev, T = A.device, ts.shape[0]
    with torch.cuda.device(dev):
        status = lib.gp_dopri5_intervals(
            A.data_ptr(), Z.data_ptr(), *scalars, ts.data_ptr(), T,
            A.shape[0], min(max_steps, 2**31 - 1), steps_per_call, *ctrl,
            *(x.data_ptr() for x in state), flags.data_ptr(), ys.data_ptr(),
            _stream(dev))
    _build.check(status, "gp_dopri5_intervals")
    _build.launch_counts["gp_dopri5_step"] += T - 1
    return state, [tuple(f) for f in flags.tolist()]


def _interval_launch(state, ys, ts, k, cap, lib, w, scalars, flags, *ctrl):
    """One launch of K9 for output interval k, updating `state` and ys[k]
    in place; returns (state, short, taken) read back from the kernel's
    flags (the launch's one device-to-host read)."""
    from . import _build
    from .fused_adaptive import _stream

    A, Z = w
    dev = A.device
    with torch.cuda.device(dev):
        status = lib.gp_dopri5_interval(
            A.data_ptr(), Z.data_ptr(), *scalars, ts.data_ptr(), k,
            A.shape[0], cap, *ctrl, *(x.data_ptr() for x in state),
            flags.data_ptr(), ys.data_ptr(), _stream(dev))
    _build.check(status, "gp_dopri5_interval")
    _build.launch_counts["gp_dopri5_step"] += 1
    short, taken = flags.tolist()
    return state, bool(short), taken


def _check_steps_per_call(steps_per_call):
    if not 0 < steps_per_call < 2**31:
        raise ValueError(f"steps_per_call must be a positive int32, got "
                         f"{steps_per_call}")


def _cap(left, steps_per_call):
    """A launch's cap of iterations: the budget left, rounded up to a
    multiple of steps_per_call (the JAX loop checks its budget once every
    steps_per_call steps), 0 once it is spent; at most the largest such
    multiple an int32 holds (K9 computes the same, interval_cap)."""
    most = (2**31 - 1) // steps_per_call * steps_per_call
    return min(max(0, -(-left // steps_per_call) * steps_per_call), most)


def _relaunching(state, ys, ts, max_steps, steps_per_call, advance):
    """The per-step solver launch by launch: one `advance(state, ys, k,
    cap)` per output interval k, and another while a chain is short of
    ts[k] and no chain has used the budget (collective).  The first i
    iterations of an interval take chain c min(i, s_c) steps, s_c the
    steps it needs there, so the batch stops where the JAX package's
    lockstep while loop stops.  Returns the final state."""
    taken = 0
    for k in range(1, ts.shape[0]):
        while True:
            state, short, taken = advance(
                state, ys, k, _cap(max_steps - taken, steps_per_call))
            if not (short and taken < max_steps):
                break
    return state


def _solve_steps(init, ts, max_steps, steps_per_call, intervals, advance):
    """The host side of the per-step solver, shared by K9 and its plain
    version.  `init()` gives a fresh (state, ys with row 0 set).  First
    every output interval once, each capped by the budget left after the
    one before (`intervals`); that is the relaunching loop's solve unless
    an interval left a chain short with budget left, which the loop would
    have launched again.  Then the solve runs once more, launch by launch
    (`_relaunching` over `advance`)."""
    state, ys = init()
    state, flags = intervals(state, ys)
    if any(short and taken < max_steps for short, taken in flags[1:]):
        state, ys = init()
        state = _relaunching(state, ys, ts, max_steps, steps_per_call,
                             advance)
    stats = {"nfe": state.nfe, "n_accepted": state.nacc,
             "n_rejected": state.nrej,
             "reached_final_time": bool((state.t1 >= ts[-1]).all())}
    return ys, stats


def _initial(w, x0, ts, static, rtol, atol):
    """init() of `_solve_steps`: the state at ts[0] and the trajectory
    buffer with x0 in row 0."""
    def init():
        with torch.no_grad():
            state = _step_init(w, x0, ts, static, rtol, atol)
        ys = torch.empty((ts.shape[0],) + tuple(state.y.shape),
                         dtype=torch.float32, device=state.y.device)
        ys[0] = state.y
        return state, ys

    return init


def gp_dopri5_solve(A, x0, ts, static, rtol=1e-7, atol=1e-9, safety=0.9,
                    ifactor=10.0, dfactor=0.2, max_steps=100_000,
                    steps_per_call=1):
    """Solve the GP-field ODE for C chains with the per-step solver.

    A (C, M, 2) per-chain weights (Kzz^{-1} L U), x0 (N, 2) shared, ts (T,)
    output times, static a `GPVectorFieldStatic`.  Returns (ys (T, C, N, 2),
    stats) with per-chain int32 nfe / n_accepted / n_rejected and the bool
    reached_final_time.  C must be a multiple of 128, as in the JAX
    package.

    One launch of kernel K9 per output interval (CUDA tensors) or its
    plain version (CPU tensors) steps every chain to the output time and
    evaluates its dense output there.  The budget `max_steps` is
    collective and checked once every `steps_per_call` steps, as in the
    JAX package: once any chain has taken that many steps, the whole batch
    stops (see reached_final_time), and the later output times extrapolate
    each chain's last step.  The T - 1 launches are issued at once, with
    one device-to-host read a solve; where the budget left a chain short
    of an output time while another chain had steps to spare, the solve
    runs again launch by launch, with a read after each.  The whole-solve
    kernel (`gp_dopri5_solve_whole`) takes the same steps with a per-chain
    budget and no host loop; prefer it.
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
    _check_steps_per_call(steps_per_call)
    lib = _build.load_library("gp_dopri5_step", (N, M))
    flags = torch.empty((T, 2), dtype=torch.int32, device=ts.device)
    ctrl = (rtol, atol, safety, ifactor, dfactor)
    spc = int(steps_per_call)

    def intervals(state, ys):
        return _intervals_launch(state, ys, ts, max_steps, spc, lib, w,
                                 field.scalars, flags, *ctrl)

    def advance(state, ys, k, cap):
        return _interval_launch(state, ys, ts, k, cap, lib, w, field.scalars,
                                flags[0], *ctrl)

    return _solve_steps(_initial(w, x0, ts, static, rtol, atol), ts,
                        max_steps, spc, intervals, advance)


def gp_dopri5_solve_plain(A, x0, ts, static, rtol=1e-7, atol=1e-9,
                          safety=0.9, ifactor=10.0, dfactor=0.2,
                          max_steps=100_000, steps_per_call=1):
    """The plain PyTorch version of `gp_dopri5_solve`, on any device: the
    same host side over the plain version of K9's output intervals."""
    from .fused_field import _prepare
    from .gp_field import gp_weights

    _check_steps_per_call(steps_per_call)
    w, x0, ts = _prepare(gp_weights(A, static), x0, ts)
    rhs = _make_rhs(*w, float(static.sf), float(static.ell))
    ctrl = (rtol, atol, safety, ifactor, dfactor)
    spc = int(steps_per_call)

    def intervals(state, ys):
        return _intervals_plain(state, ys, ts, max_steps, spc, rhs, *ctrl)

    def advance(state, ys, k, cap):
        return _interval_plain(state, ys, ts, k, cap, rhs, *ctrl)

    with torch.no_grad():
        return _solve_steps(_initial(w, x0, ts, static, rtol, atol), ts,
                            max_steps, spc, intervals, advance)
