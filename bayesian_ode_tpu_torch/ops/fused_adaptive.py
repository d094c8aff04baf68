"""Recording whole-solve forward and replay backward of the fused adaptive
engine: the kernel wrappers and their plain PyTorch versions.

Counterpart of `bayesian_ode_tpu/ops/fused_adaptive.py`.  The TPU kernels
`make_fwd_rec_kernel` (K2) and `make_bwd_kernel` (K3) become the CUDA
templates of `csrc/dopri5_kernels.cuh` over a field functor and a tableau
(DOPRI5 or TSIT5).  Each field registered with the engine
(`ops/fused_field.py::FusedField`: GP, MLP, spiral, FitzHugh-Nagumo) has
its own library, which holds the recording forward (K2), the same forward
without records (for the GP field, K1) and the replay backward (K3) for
both tableaus.

Records hold each chain's own accepted steps, laid out
(store_steps, 2N + 2, C): the step's start state (2N floats), t0 and dt.
Rejected steps are not recorded: in the frozen-mesh adjoint they pass the
cotangent through unchanged.  A chain that accepts more than
`store_steps` steps makes the wrapper raise instead of returning a wrong
gradient.

The plain versions take the field's batched torch `rhs` and `rhs_vjp`
(over (C, N, 2) states) and a tableau, and repeat the kernels' step
arithmetic.  The wrappers take them only for CPU tensors; CUDA tensors
launch the kernels or raise.
"""
from __future__ import annotations

import torch

from ..ode.tableaus import DOPRI5, TSIT5
from . import _build
from .gp_dopri5 import (
    _bc,
    _midpoint,
    _quartic_coeffs,
    _rk_stages,
    _step_decision,
)

TABLEAUS = {"dopri5": DOPRI5, "tsit5": TSIT5}


def _check_tableau(tableau) -> None:
    """The engine takes a 7-stage FSAL pair with quartic dense output
    (DOPRI5, TSIT5): 6 beta rows, k7 = f(y1), c_mid present."""
    if len(tableau.beta) != 6 or tableau.c_mid is None:
        raise ValueError("fused kernels support 7-stage FSAL tableaus "
                         "with c_mid dense output (dopri5, tsit5)")
    if any(abs(a - b) > 1e-12 for a, b in zip(tableau.c_sol[:6],
                                              tableau.beta[5])):
        raise ValueError("tableau is not FSAL (c_sol != last beta row)")


# the most steps a chain accepted in a recording forward since the last
# reset (the check below reads it anyway): how close a run came to
# store_steps
record_high_water = {"steps": 0}


def _check_records(nacc, store_steps) -> None:
    worst = int(nacc.max()) if nacc.numel() else 0
    record_high_water["steps"] = max(record_high_water["steps"], worst)
    if worst > store_steps:
        raise RuntimeError(
            f"a chain accepted {worst} steps but store_steps={store_steps}: "
            "the recorded step mesh would be incomplete and the gradient "
            "wrong; raise store_steps")


def _per_chain(mask, x):
    """The (C,) mask broadcast against a per-chain tensor x (C, ...)."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - 1))


# ---------------------------------------------------------------------------
# forward: K2 (record=True), and the same solve without records
# ---------------------------------------------------------------------------

def fwd_plain(rhs, x0b, f0, dt0, ts, rtol, atol, safety, ifactor, dfactor,
              max_steps, controller, store_steps=None, tableau=DOPRI5):
    """Plain version of the whole-solve forward, on any device.

    `rhs` maps (C, N, 2) states to their slopes.  The chains advance in
    masked lockstep; each chain's arithmetic is the kernel's.  Step sizes
    are detached, so autograd through this function gives the same
    frozen-step-mesh gradient as the replay backward.  Returns
    (ys (T, C, N, 2), nfe, n_accepted, n_rejected (C,) int32, t1 (C,),
    rec (store_steps, 2N + 2, C) or None)."""
    _check_tableau(tableau)
    C, N = x0b.shape[0], x0b.shape[1]
    T = ts.shape[0]
    dev = x0b.device
    pi = controller == "pi"
    y, f = x0b, f0
    t1 = ts[0].expand(C).clone()
    dt = dt0.detach()
    ep = torch.ones(C, dtype=torch.float32, device=dev)
    nfe = torch.full((C,), 2, dtype=torch.int32, device=dev)
    nacc = torch.zeros(C, dtype=torch.int32, device=dev)
    nrej = torch.zeros(C, dtype=torch.int32, device=dev)
    ys = torch.zeros((T, C, N, 2), dtype=torch.float32, device=dev)
    rec = None
    if store_steps is not None:
        rec = torch.zeros((store_steps, 2 * N + 2, C), dtype=torch.float32,
                          device=dev)
    tf = ts[-1]
    while True:
        active = (t1 < tf) & (nacc + nrej < max_steps)
        if not bool(active.any()):
            break
        k, y1 = _rk_stages(rhs, y, f, dt, tableau)
        accept, _, dt_next, ep_next = _step_decision(
            k, y, y1, dt, rtol, atol, safety, ifactor, dfactor,
            err_prev=ep if pi else None, tableau=tableau)
        take = active & accept
        if rec is not None:
            cs = (take & (nacc < store_steps)).nonzero().squeeze(1)
            if cs.numel():
                row = torch.cat([y.reshape(C, -1), t1[:, None], dt[:, None]],
                                dim=1)
                rec[nacc[cs].long(), :, cs] = row[cs].detach()
        tn = t1 + dt
        emit = (ts[:, None] > t1) & (ts[:, None] <= tn) & take    # (T, C)
        if bool(emit.any()):
            ym = _midpoint(y, k, dt, tableau)
            a, b, c, d, e = _quartic_coeffs(y, y1, ym, f, k[6], _bc(dt))
            X = ((ts[:, None] - t1) / dt)[..., None, None]   # (T, C, 1, 1)
            val = (((a * X + b) * X + c) * X + d) * X + e
            ys = torch.where(emit[..., None, None], val, ys)
        sel = _bc(take)
        y = torch.where(sel, y1, y)
        f = torch.where(sel, k[6], f)
        t1 = torch.where(take, tn, t1)
        dt = torch.where(active, dt_next.detach(), dt)
        if pi:
            ep = torch.where(active, ep_next, ep)
        nfe = nfe + 6 * active.int()
        nacc = nacc + take.int()
        nrej = nrej + (active & ~accept).int()
    # output times never crossed (budget exhaustion) hold the final state
    rest = ts[:, None] > t1
    ys = torch.where(rest[..., None, None], y.unsqueeze(0), ys)
    ys = torch.cat([x0b.unsqueeze(0), ys[1:]], dim=0)
    if rec is not None:
        _check_records(nacc, store_steps)
    return ys, nfe, nacc, nrej, t1, rec


def _check_args(device, **named):
    """Each named (tensor, shape, dtype) lies on `device`, contiguous, of
    that dtype and shape: the kernels index them without bounds checks."""
    for name, (t, shape, dtype) in named.items():
        if (t.device != device or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(
                f"{name}: expected a contiguous {dtype} tensor of shape "
                f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def _check_weights(field, w):
    f32 = torch.float32
    _check_args(w[0].device, **{f"{field.name} weight {i}": (x, s, f32)
                                for i, (x, s) in enumerate(
                                    zip(w, field.shapes(w)))})


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_fwd(field, w, x0b, f0, dt0, ts, rtol, atol, safety, ifactor,
                dfactor, max_steps, controller, record, store_steps, method):
    C, N, T = x0b.shape[0], x0b.shape[1], ts.shape[0]
    x0 = x0b[0].contiguous()
    f0, dt0 = f0.contiguous(), dt0.contiguous()
    f32 = torch.float32
    dev = w[0].device
    _check_weights(field, w)
    _check_args(dev, x0=(x0, (N, 2), f32), f0=(f0, (C, N, 2), f32),
                dt0=(dt0, (C,), f32), ts=(ts, (T,), f32))
    if not 0 < max_steps < 2**31:
        raise ValueError(f"max_steps must fit int32, got {max_steps}")
    lib = _build.load_library(*field.library(w, N))
    ys = torch.empty((T, C, N, 2), dtype=f32, device=dev)
    nfe = torch.empty(C, dtype=torch.int32, device=dev)
    nacc = torch.empty(C, dtype=torch.int32, device=dev)
    nrej = torch.empty(C, dtype=torch.int32, device=dev)
    t1 = torch.empty(C, dtype=f32, device=dev)
    rec = (torch.empty((store_steps, 2 * N + 2, C), dtype=f32, device=dev)
           if record else None)
    with torch.cuda.device(dev):
        status = getattr(lib, f"{field.name}_dopri5_fwd")(
            int(record), _build.TABLEAUS.index(method),
            *(x.data_ptr() for x in w), *field.scalars, x0.data_ptr(),
            f0.data_ptr(), dt0.data_ptr(), ts.data_ptr(), C, T, rtol, atol,
            safety, ifactor, dfactor, int(max_steps),
            int(controller == "pi"), int(store_steps if record else 0),
            ys.data_ptr(), nfe.data_ptr(), nacc.data_ptr(), nrej.data_ptr(),
            t1.data_ptr(), rec.data_ptr() if record else None, _stream(dev))
    _build.check(status, f"{field.name}_dopri5_fwd")
    kind = "fwd_record" if record else "solve_whole"
    _build.launch_counts[f"{field.name}_{method}_{kind}"] += 1
    return ys, nfe, nacc, nrej, t1, rec


def fwd(field, w, x0b, f0, dt0, ts, rtol, atol, safety, ifactor, dfactor,
        max_steps, controller, record, store_steps=128, method="dopri5"):
    """Whole-solve forward of `field` with weights `w`: the recording
    kernel (K2) when `record` (records for `bwd`), else the same solve
    without records (K1 for the GP field).  Same results as `fwd_plain`.
    """
    if w[0].is_cuda:
        out = _launch_fwd(field, w, x0b, f0, dt0, ts, rtol, atol, safety,
                          ifactor, dfactor, max_steps, controller, record,
                          store_steps, method)
        if record:
            _check_records(out[2], store_steps)
        return out
    if w[0].device.type != "cpu":
        raise ValueError(f"unsupported device {w[0].device}")
    return fwd_plain(field.make_rhs(w), x0b, f0, dt0, ts, rtol, atol, safety,
                     ifactor, dfactor, max_steps, controller,
                     store_steps if record else None, TABLEAUS[method])


# ---------------------------------------------------------------------------
# backward: K3
# ---------------------------------------------------------------------------

def bwd_plain(rhs, rhs_vjp, w, ts, rec, nacc, g, tableau=DOPRI5):
    """Plain version of the replay backward, on any device: each chain
    sweeps its own records in reverse (masked lockstep over chains).

    `rhs_vjp(y, cot)` returns (ybar, a tuple of cotangents of the weights
    `w`, the per-chain blocks that get one).  g (T, C, N, 2) is the
    cotangent of the trajectory; row 0 (x0) is not handled here.  Returns
    (the weight cotangents, a tuple like w; lbar (C, N, 2))."""
    _check_tableau(tableau)
    beta, c_mid = tableau.beta, tableau.c_mid
    R, C = rec.shape[1], rec.shape[2]
    NS = R - 2
    N = NS // 2
    dev = rec.device
    lbar = torch.zeros((C, N, 2), dtype=torch.float32, device=dev)
    wbar = tuple(torch.zeros_like(x) for x in w)
    chains = torch.arange(C, device=dev)
    n_iter = int(nacc.max()) if C else 0
    for j in range(n_iter):
        s = nacc.long() - 1 - j
        act = s >= 0
        row = rec[s.clamp_min(0), :, chains]                      # (C, R)
        y0 = row[:, :NS].reshape(C, N, 2)
        t0, dt = row[:, NS], row[:, NS + 1]
        dts = torch.where(dt > 0, dt, torch.ones_like(dt))
        dtc = _bc(dts)

        # recompute the stages, keeping the stage points
        k = [rhs(y0)]
        us = []
        for beta_i in beta:
            u = y0 + dtc * sum(b * kk for b, kk in zip(beta_i, k) if b != 0)
            us.append(u)
            k.append(rhs(u))

        # cotangents of the emitted output times -> quartic coefficients
        emit = (ts[:, None] > t0) & (ts[:, None] <= t0 + dt) & act  # (T, C)
        X1 = torch.where(emit, (ts[:, None] - t0) / dts, torch.zeros_like(t0))
        X2 = X1 * X1
        X3 = X2 * X1
        X4 = X2 * X2
        wgt = torch.where(emit[..., None, None], g, torch.zeros_like(g))

        def moment(X):
            return (wgt * X[..., None, None]).sum(dim=0)           # (C, N, 2)

        a, b, c, d, e = moment(X4), moment(X3), moment(X2), moment(X1), \
            wgt.sum(dim=0)
        y0b = -8 * a + 18 * b - 11 * c + e
        y1b = -8 * a + 14 * b - 5 * c
        ymb = 16 * a - 32 * b + 16 * c
        f0b = dtc * (-2 * a + 5 * b - 4 * c + d)
        f1b = dtc * (2 * a - 3 * b + c)

        # y_mid = y0 + dt * (c_mid . k)
        kb = [dtc * cm * ymb if cm != 0 else torch.zeros_like(ymb)
              for cm in c_mid]
        y0b = y0b + ymb

        def vjp(u, cot, acc):
            ub, dw = rhs_vjp(u, cot)
            return ub, dw if acc is None else tuple(
                x + y for x, y in zip(acc, dw))

        # k7 = f(y1): carried-in f1 share + c_mid share
        ub, wbar_i = vjp(us[5], kb[6] + f1b, None)
        y1t = lbar + y1b + ub
        # y1 = y0 + dt * (beta[5] . k)
        y0b = y0b + y1t
        for jj, bb in enumerate(beta[5]):
            if bb != 0:
                kb[jj] = kb[jj] + dtc * bb * y1t
        # stages 6..2: k[r+1] = f(u[r]), u[r] = y0 + dt * (beta[r] . k)
        for r in range(4, -1, -1):
            ub, wbar_i = vjp(us[r], kb[r + 1], wbar_i)
            y0b = y0b + ub
            for jj, bb in enumerate(beta[r]):
                if bb != 0:
                    kb[jj] = kb[jj] + dtc * bb * ub
        # k1 = f(y0): the FSAL slope is recomputed, f0's share lands here
        ub, wbar_i = vjp(y0, kb[0] + f0b, wbar_i)
        y0b = y0b + ub

        lbar = torch.where(_bc(act), y0b, lbar)
        wbar = tuple(
            x + torch.where(_per_chain(act, xi), xi, torch.zeros_like(xi))
            for x, xi in zip(wbar, wbar_i))
    return wbar, lbar


def _launch_bwd(field, w, ts, rec, nacc, g, method):
    C, T, N = w[0].shape[0], g.shape[0], g.shape[2]
    g = g.to(torch.float32).contiguous()
    f32 = torch.float32
    dev = w[0].device
    _check_weights(field, w)
    _check_args(dev, ts=(ts, (T,), f32),
                rec=(rec, (rec.shape[0], 2 * N + 2, C), f32),
                nacc=(nacc, (C,), torch.int32), g=(g, (T, C, N, 2), f32))
    lib = _build.load_library(*field.library(w, N))
    wbar = tuple(torch.empty_like(x) for x in w[:field.n_wbar])
    lbar = torch.empty((C, N, 2), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        status = getattr(lib, f"{field.name}_dopri5_bwd")(
            _build.TABLEAUS.index(method), *(x.data_ptr() for x in w),
            *field.scalars, *(x.data_ptr() for x in wbar), ts.data_ptr(),
            rec.data_ptr(), nacc.data_ptr(), g.data_ptr(), C, T,
            lbar.data_ptr(), _stream(dev))
    _build.check(status, f"{field.name}_dopri5_bwd")
    _build.launch_counts[f"{field.name}_{method}_bwd"] += 1
    return wbar, lbar


def bwd(field, w, ts, rec, nacc, g, method="dopri5"):
    """Replay backward (K3) of `field`: (the cotangents of its first
    `n_wbar` weight blocks, lbar (C, N, 2)) from the records of
    `fwd(record=True)` and the trajectory cotangent g."""
    if w[0].is_cuda:
        return _launch_bwd(field, w, ts, rec, nacc, g, method)
    if w[0].device.type != "cpu":
        raise ValueError(f"unsupported device {w[0].device}")
    return bwd_plain(field.make_rhs(w), field.make_rhs_vjp(w),
                     w[:field.n_wbar], ts, rec, nacc, g, TABLEAUS[method])
