"""Recording whole-solve forward and replay backward of the fused dopri5
engine: the kernel wrappers and their plain PyTorch versions.

Counterpart of `bayesian_ode_tpu/ops/fused_adaptive.py`.  The TPU kernels
`make_fwd_rec_kernel` (K2) and `make_bwd_kernel` (K3) become the CUDA
kernels of `csrc/gp_dopri5_fwd.cu` (one template: K1 when RECORD=false,
K2 when true) and `csrc/gp_dopri5_bwd.cu` (K3).  The device code is
generic over a field functor (`csrc/dopri5_common.cuh`), with the GP field
as its only instance so far; the other fields are ROADMAP queue 1 item 9.

Records hold each chain's own accepted steps, laid out
(store_steps, 2N + 2, C): the step's start state (2N floats), t0 and dt.
Rejected steps are not recorded: in the frozen-mesh adjoint they pass the
cotangent through unchanged.  A chain that accepts more than
`store_steps` steps makes the wrapper raise instead of returning a wrong
gradient.

The wrappers take the plain versions only for CPU tensors; CUDA tensors
launch the kernels or raise.
"""
from __future__ import annotations

import torch

from ..ode.tableaus import DOPRI5
from . import _build
from .gp_dopri5 import (
    _bc,
    _make_rhs,
    _make_rhs_vjp,
    _midpoint,
    _quartic_coeffs,
    _rk_stages,
    _step_decision,
)


def _check_records(nacc, store_steps) -> None:
    worst = int(nacc.max()) if nacc.numel() else 0
    if worst > store_steps:
        raise RuntimeError(
            f"a chain accepted {worst} steps but store_steps={store_steps}: "
            "the recorded step mesh would be incomplete and the gradient "
            "wrong; raise store_steps")


# ---------------------------------------------------------------------------
# forward: K1 (record=False) / K2 (record=True)
# ---------------------------------------------------------------------------

def fwd_plain(A, Z, x0b, f0, dt0, ts, sf, ell, rtol, atol, safety, ifactor,
              dfactor, max_steps, controller, store_steps=None):
    """Plain version of the whole-solve forward, on any device.

    The chains advance in masked lockstep; each chain's arithmetic is the
    kernel's.  Step sizes are detached, so autograd through this function
    gives the same frozen-step-mesh gradient as the replay backward.
    Returns (ys (T, C, N, 2), nfe, n_accepted, n_rejected (C,) int32,
    t1 (C,), rec (store_steps, 2N + 2, C) or None)."""
    rhs = _make_rhs(A, Z, sf, ell)
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
        k, y1 = _rk_stages(rhs, y, f, dt)
        accept, _, dt_next, ep_next = _step_decision(
            k, y, y1, dt, rtol, atol, safety, ifactor, dfactor,
            err_prev=ep if pi else None)
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
            ym = _midpoint(y, k, dt)
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


def _launch_fwd(A, Z, x0b, f0, dt0, ts, sf, ell, rtol, atol, safety,
                ifactor, dfactor, max_steps, controller, record, store_steps):
    C, M = A.shape[0], A.shape[1]
    N, T = x0b.shape[1], ts.shape[0]
    x0 = x0b[0].contiguous()
    f0, dt0 = f0.contiguous(), dt0.contiguous()
    f32 = torch.float32
    _check_args(A.device, A=(A, (C, M, 2), f32), Z=(Z, (M, 2), f32),
                x0=(x0, (N, 2), f32), f0=(f0, (C, N, 2), f32),
                dt0=(dt0, (C,), f32), ts=(ts, (T,), f32))
    if not 0 < max_steps < 2**31:
        raise ValueError(f"max_steps must fit int32, got {max_steps}")
    lib = _build.load_library(N, M)
    dev = A.device
    ys = torch.empty((T, C, N, 2), dtype=torch.float32, device=dev)
    nfe = torch.empty(C, dtype=torch.int32, device=dev)
    nacc = torch.empty(C, dtype=torch.int32, device=dev)
    nrej = torch.empty(C, dtype=torch.int32, device=dev)
    t1 = torch.empty(C, dtype=torch.float32, device=dev)
    rec = (torch.empty((store_steps, 2 * N + 2, C), dtype=torch.float32,
                       device=dev) if record else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.gp_dopri5_fwd(
            int(record), A.data_ptr(), x0.data_ptr(), f0.data_ptr(),
            dt0.data_ptr(), Z.data_ptr(), ts.data_ptr(), C, T, sf * sf,
            0.5 / (ell * ell), rtol, atol, safety, ifactor, dfactor,
            int(max_steps), int(controller == "pi"),
            int(store_steps if record else 0), ys.data_ptr(),
            nfe.data_ptr(), nacc.data_ptr(), nrej.data_ptr(), t1.data_ptr(),
            rec.data_ptr() if record else None, stream)
    _build.check(status, "gp_dopri5_fwd")
    _build.launch_counts["gp_dopri5_fwd_record" if record
                         else "gp_dopri5_solve_whole"] += 1
    return ys, nfe, nacc, nrej, t1, rec


def fwd(A, Z, x0b, f0, dt0, ts, sf, ell, rtol, atol, safety, ifactor,
        dfactor, max_steps, controller, record, store_steps=128):
    """Whole-solve forward: K2 when `record` (records for `bwd`), else K1.
    Same arguments and results as `fwd_plain`."""
    if A.is_cuda:
        out = _launch_fwd(A, Z, x0b, f0, dt0, ts, sf, ell, rtol, atol,
                          safety, ifactor, dfactor, max_steps, controller,
                          record, store_steps)
        if record:
            _check_records(out[2], store_steps)
        return out
    if A.device.type != "cpu":
        raise ValueError(f"unsupported device {A.device}")
    return fwd_plain(A, Z, x0b, f0, dt0, ts, sf, ell, rtol, atol, safety,
                     ifactor, dfactor, max_steps, controller,
                     store_steps if record else None)


# ---------------------------------------------------------------------------
# backward: K3
# ---------------------------------------------------------------------------

def bwd_plain(A, Z, ts, rec, nacc, g, sf, ell):
    """Plain version of the replay backward, on any device: each chain
    sweeps its own records in reverse (masked lockstep over chains).
    g (T, C, N, 2) is the cotangent of the trajectory; row 0 (x0) is not
    handled here.  Returns (Abar (C, M, 2), lbar (C, N, 2))."""
    rhs = _make_rhs(A, Z, sf, ell)
    vjp = _make_rhs_vjp(A, Z, sf, ell)
    beta, c_mid = DOPRI5.beta, DOPRI5.c_mid
    R, C = rec.shape[1], rec.shape[2]
    NS = R - 2
    N = NS // 2
    lbar = torch.zeros((C, N, 2), dtype=torch.float32, device=A.device)
    Abar = torch.zeros_like(A)
    chains = torch.arange(C, device=A.device)
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

        # k7 = f(y1): carried-in f1 share + c_mid share
        ub, Abar_i = vjp(us[5], kb[6] + f1b)
        y1t = lbar + y1b + ub
        # y1 = y0 + dt * (beta[5] . k)
        y0b = y0b + y1t
        for jj, bb in enumerate(beta[5]):
            if bb != 0:
                kb[jj] = kb[jj] + dtc * bb * y1t
        # stages 6..2: k[r+1] = f(u[r]), u[r] = y0 + dt * (beta[r] . k)
        for r in range(4, -1, -1):
            ub, Ab = vjp(us[r], kb[r + 1])
            Abar_i = Abar_i + Ab
            y0b = y0b + ub
            for jj, bb in enumerate(beta[r]):
                if bb != 0:
                    kb[jj] = kb[jj] + dtc * bb * ub
        # k1 = f(y0): the FSAL slope is recomputed, f0's share lands here
        ub, Ab = vjp(y0, kb[0] + f0b)
        Abar_i = Abar_i + Ab
        y0b = y0b + ub

        sel = _bc(act)
        lbar = torch.where(sel, y0b, lbar)
        Abar = Abar + torch.where(sel, Abar_i, torch.zeros_like(Abar_i))
    return Abar, lbar


def _launch_bwd(A, Z, ts, rec, nacc, g, sf, ell):
    C, M = A.shape[0], A.shape[1]
    T, N = g.shape[0], g.shape[2]
    g = g.to(torch.float32).contiguous()
    f32 = torch.float32
    _check_args(A.device, A=(A, (C, M, 2), f32), Z=(Z, (M, 2), f32),
                ts=(ts, (T,), f32),
                rec=(rec, (rec.shape[0], 2 * N + 2, C), f32),
                nacc=(nacc, (C,), torch.int32), g=(g, (T, C, N, 2), f32))
    lib = _build.load_library(N, M)
    dev = A.device
    Abar = torch.empty_like(A)
    lbar = torch.empty((C, N, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.gp_dopri5_bwd(
            A.data_ptr(), Z.data_ptr(), ts.data_ptr(), rec.data_ptr(),
            nacc.data_ptr(), g.data_ptr(), C, T, sf * sf,
            0.5 / (ell * ell), 1.0 / (ell * ell), Abar.data_ptr(),
            lbar.data_ptr(), stream)
    _build.check(status, "gp_dopri5_bwd")
    _build.launch_counts["gp_dopri5_bwd"] += 1
    return Abar, lbar


def bwd(A, Z, ts, rec, nacc, g, sf, ell):
    """Replay backward (K3): (Abar (C, M, 2), lbar (C, N, 2)) from the
    records of `fwd(record=True)` and the trajectory cotangent g."""
    if A.is_cuda:
        return _launch_bwd(A, Z, ts, rec, nacc, g, sf, ell)
    if A.device.type != "cpu":
        raise ValueError(f"unsupported device {A.device}")
    return bwd_plain(A, Z, ts, rec, nacc, g, sf, ell)
