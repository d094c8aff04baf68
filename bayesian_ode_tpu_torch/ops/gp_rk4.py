"""Fused fixed-grid rk4 trajectories of the GP field with a hand-written
backward, and the fused GP posterior potential of the rk4 path.

Counterpart of `bayesian_ode_tpu/ops/gp_rk4.py`.  The TPU kernels
`_make_fwd_kernel` (K4) and `_make_bwd_kernel` (K5) become the CUDA
kernels `gp_rk4_fwd` and `gp_rk4_bwd` of `csrc/gp_rk4.cu`, both one
thread per trajectory point on the GP field functor `GPPoint` of
`csrc/gp_field.cuh` (or `GPWidePoint`, `csrc/gp_wide_field.cuh`, past
N = 32 or where GPPoint's block passes an H100 block's shared memory; to
N = 128 and M = 1,024 inducing points: `_build.check_shape`) and the rk4
templates of `csrc/rk4_common.cuh`:

  - forward: all T-1 steps of the 3/8 rule on the output grid, storing
    the whole trajectory, which is both the output and the residual of
    the backward;
  - backward: the reverse sweep over the stored trajectory, injecting the
    observation cotangent g[t+1] at each step's end point, recomputing the
    four stages and pulling the cotangent through the field VJP, so Abar
    accumulates per chain.

Step sizes are diff(ts) in float32, as in the JAX package.  The plain
versions below compute the same sums in the same order (`_rk4_fwd_plain`
and `_rk4_bwd_plain` are generic over the field, and `ops/mlp_rk4.py`
uses them too); the plain backward is the hand-written reverse sweep, not
autograd.  The wrappers take the plain versions only for CPU tensors; CUDA
tensors launch the kernels or raise.
"""
from __future__ import annotations

import torch

from ..models.kernel_regression import full_f32_matmul, make_batch_potential
from . import _build
from .fused_adaptive import _check_args, _stream
from .gp_dopri5 import _make_rhs, _make_rhs_vjp

# ---------------------------------------------------------------------------
# the 3/8-rule step and its transpose, generic over the field
# ---------------------------------------------------------------------------


def _stage_points(rhs, p, dt):
    k1 = rhs(p)
    u2 = p + dt / 3 * k1
    k2 = rhs(u2)
    u3 = p + dt * (-k1 / 3 + k2)
    k3 = rhs(u3)
    u4 = p + dt * (k1 - k2 + k3)
    return k1, k2, k3, u2, u3, u4


def _rk4_fwd_plain(rhs, x0b, dts):
    """Trajectories (T, C, ...) from x0b (C, ...) over the steps dts."""
    ys, p = [x0b], x0b
    for t in range(dts.shape[0]):
        dt = dts[t]
        k1, k2, k3, _, _, u4 = _stage_points(rhs, p, dt)
        k4 = rhs(u4)
        p = p + dt / 8 * (k1 + 3 * k2 + 3 * k3 + k4)
        ys.append(p)
    return torch.stack(ys)


def _rk4_bwd_plain(rhs, rhs_vjp, ys, g, dts, wbar):
    """The reverse sweep: `rhs_vjp(y, cot)` returns (ybar, a tuple of
    weight cotangents), which are summed into `wbar` (a tuple of zeros on
    entry).  Returns (wbar, the per-chain x0 cotangent including g[0])."""
    lam = torch.zeros_like(ys[0])

    def vjp(u, cot):
        nonlocal wbar
        ub, dw = rhs_vjp(u, cot)
        wbar = tuple(a + b for a, b in zip(wbar, dw))
        return ub

    for t in range(dts.shape[0] - 1, -1, -1):
        dt = dts[t]
        lam = lam + g[t + 1]
        p = ys[t]
        _, _, _, u2, u3, u4 = _stage_points(rhs, p, dt)
        # reverse of: next = p + dt/8 (k1 + 3 k2 + 3 k3 + k4)
        pb = lam
        kb1 = dt / 8 * lam
        kb2 = 3 * dt / 8 * lam
        kb3 = 3 * dt / 8 * lam
        kb4 = dt / 8 * lam
        ub = vjp(u4, kb4)
        pb = pb + ub
        kb1 = kb1 + dt * ub
        kb2 = kb2 + -dt * ub
        kb3 = kb3 + dt * ub
        ub = vjp(u3, kb3)
        pb = pb + ub
        kb1 = kb1 + -dt / 3 * ub
        kb2 = kb2 + dt * ub
        ub = vjp(u2, kb2)
        pb = pb + ub
        kb1 = kb1 + dt / 3 * ub
        lam = pb + vjp(p, kb1)
    return wbar, lam + g[0]


# ---------------------------------------------------------------------------
# K4 / K5 and their plain versions
# ---------------------------------------------------------------------------

def gp_rk4_fwd_plain(A, Z, x0, dts, sf, ell):
    """Plain version of K4, on any device and dtype: trajectories
    (T, C, N, 2) of the GP field with weights A (C, M, 2) from the shared
    x0 (N, 2) over the steps dts (T-1,)."""
    x0b = x0.to(A.dtype).expand(A.shape[0], *x0.shape[-2:])
    return _rk4_fwd_plain(_make_rhs(A, Z, sf, ell), x0b, dts)


def gp_rk4_bwd_plain(A, Z, ys, g, dts, sf, ell):
    """Plain version of K5: (Abar (C, M, 2), lbar (C, N, 2)) for the
    trajectory ys and its cotangent g, both (T, C, N, 2); lbar is the
    per-chain x0 cotangent including g[0]."""
    vjp = _make_rhs_vjp(A, Z, sf, ell)

    def rhs_vjp(u, cot):
        ub, Ab = vjp(u, cot)
        return ub, (Ab,)

    (Abar,), lbar = _rk4_bwd_plain(_make_rhs(A, Z, sf, ell), rhs_vjp, ys, g,
                                   dts, (torch.zeros_like(A),))
    return Abar, lbar


def _launch_fwd(A, Z, x0, dts, sf, ell):
    C, M = A.shape[0], A.shape[1]
    N, T = x0.shape[0], dts.shape[0] + 1
    f32 = torch.float32
    _check_args(A.device, A=(A, (C, M, 2), f32), Z=(Z, (M, 2), f32),
                x0=(x0, (N, 2), f32), dts=(dts, (T - 1,), f32))
    lib = _build.load_library("gp_rk4", (N, M))
    ys = torch.empty((T, C, N, 2), dtype=f32, device=A.device)
    with torch.cuda.device(A.device):
        status = lib.gp_rk4_fwd(A.data_ptr(), x0.data_ptr(), Z.data_ptr(),
                                dts.data_ptr(), C, T, sf * sf,
                                0.5 / (ell * ell), ys.data_ptr(),
                                _stream(A.device))
    _build.check(status, "gp_rk4_fwd")
    _build.launch_counts["gp_rk4_fwd"] += 1
    return ys


def _launch_bwd(A, Z, ys, g, dts, sf, ell):
    C, M = A.shape[0], A.shape[1]
    T, N = ys.shape[0], ys.shape[2]
    g = g.to(torch.float32).contiguous()
    f32 = torch.float32
    _check_args(A.device, A=(A, (C, M, 2), f32), Z=(Z, (M, 2), f32),
                ys=(ys, (T, C, N, 2), f32), g=(g, (T, C, N, 2), f32),
                dts=(dts, (T - 1,), f32))
    lib = _build.load_library("gp_rk4", (N, M))
    Abar = torch.empty_like(A)
    lbar = torch.empty((C, N, 2), dtype=f32, device=A.device)
    with torch.cuda.device(A.device):
        status = lib.gp_rk4_bwd(A.data_ptr(), Z.data_ptr(), dts.data_ptr(),
                                ys.data_ptr(), g.data_ptr(), C, T, sf * sf,
                                0.5 / (ell * ell), 1.0 / (ell * ell),
                                Abar.data_ptr(), lbar.data_ptr(),
                                _stream(A.device))
    _build.check(status, "gp_rk4_bwd")
    _build.launch_counts["gp_rk4_bwd"] += 1
    return Abar, lbar


def gp_rk4_fwd(A, Z, x0, dts, sf, ell):
    """K4 for CUDA tensors, its plain version for CPU tensors."""
    if A.is_cuda:
        return _launch_fwd(A, Z, x0, dts, sf, ell)
    if A.device.type != "cpu":
        raise ValueError(f"unsupported device {A.device}")
    return gp_rk4_fwd_plain(A, Z, x0, dts, sf, ell)


def gp_rk4_bwd(A, Z, ys, g, dts, sf, ell):
    """K5 for CUDA tensors, its plain version for CPU tensors."""
    if A.is_cuda:
        return _launch_bwd(A, Z, ys, g, dts, sf, ell)
    if A.device.type != "cpu":
        raise ValueError(f"unsupported device {A.device}")
    return gp_rk4_bwd_plain(A, Z, ys, g, dts, sf, ell)


class _Trajectory(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, x0, dts, Z, sf, ell):
        ys = gp_rk4_fwd(A, Z, x0, dts, sf, ell)
        ctx.save_for_backward(A, Z, dts, ys)
        ctx.sf, ctx.ell = sf, ell
        return ys

    @staticmethod
    def backward(ctx, g):
        A, Z, dts, ys = ctx.saved_tensors
        Abar, lbar = gp_rk4_bwd(A, Z, ys, g, dts, ctx.sf, ctx.ell)
        # x0 is shared by the chains
        return Abar, lbar.sum(dim=0), None, None, None, None


def _steps(ts, dev):
    """diff(ts) in float32, as the JAX package's kernels take them."""
    ts = torch.as_tensor(ts, device=dev).to(torch.float32)
    return torch.diff(ts).contiguous()


def gp_rk4_trajectory(A, x0, ts, static):
    """rk4 (3/8 rule) trajectories of the GP field for C chains on the
    output grid ts, differentiable with respect to A and x0 through the
    hand-written backward.

    A (C, M, 2), x0 (N, 2) shared, ts (T,) increasing.  Returns
    (T, C, N, 2) float32.  CUDA tensors launch K4 forward and K5
    backward; CPU tensors take their plain versions.
    """
    if A.is_cuda:
        full_f32_matmul()
    dev = A.device
    return _Trajectory.apply(
        A.to(torch.float32).contiguous(),
        x0.to(device=dev, dtype=torch.float32).contiguous(),
        _steps(ts, dev),
        static.Z.to(device=dev, dtype=torch.float32).contiguous(),
        float(static.sf), float(static.ell))


def make_fused_gp_potential(static, x0, ts, Y):
    """GP posterior potential of a chain batch with the solve by fixed-grid
    rk4 on the observation times, through the fused kernels.

    Returns potential_batch(params) -> (C,) for params
    {'U': (C, M, 2), 'logsn': (C, 2)}; term by term the JAX package's
    `make_fused_gp_potential`.
    """
    return make_batch_potential(
        static, Y, lambda A: gp_rk4_trajectory(A, x0, ts, static))
