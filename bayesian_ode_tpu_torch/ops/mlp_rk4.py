"""Fused fixed-grid rk4 trajectories of the MLP field with a hand-written
backward, and the fused MLP posterior potential.

Counterpart of `bayesian_ode_tpu/ops/mlp_rk4.py`, the field of BASELINE
config 3 (Van der Pol with the NN mean function under pSGLD):

    f(x) = W3^T elu(W2^T elu(W1^T x + b1) + b2) + b3,   x in R^2, H hidden

The TPU kernels `_make_fwd_kernel` (K6) and `_make_bwd_kernel` (K7) become
the CUDA kernels `mlp_rk4_fwd` and `mlp_rk4_bwd` of `csrc/mlp_rk4.cu`, on
the MLP field functor of `csrc/mlp_field.cuh` (one warp per chain, one
hidden unit and one state component per lane, to H = 32 and N = 16) or,
past those, of `csrc/mlp_wide_field.cuh` (one warp and block per chain,
ceil(H/32) units a lane, W2 in shared memory), and the rk4 templates the
GP kernels use.  The weights stay in the layer-list layout,
w1 (C, 2, H), b1 (C, H), w2 (C, H, H), b2 (C, H), w3 (C, H, 2),
b3 (C, 2), and so do the weight cotangents.  The kernels take H <= 128 at
N <= 16 and H <= 64 at N <= 32; a wider field raises NotImplementedError
on the card before any build (`_build.check_shape`, ROADMAP queue 1 item
19).

The plain versions use the 3/8-rule step and reverse sweep of
`ops/gp_rk4.py` over a batched torch field; their products are matmuls,
which run in full float32 on the card (`full_f32_matmul`).  ELU is
exp(a) - 1 with derivative a > 0 ? 1 : exp(a), as in the TPU kernel.
"""
from __future__ import annotations

import torch

from ..models.kernel_regression import full_f32_matmul
from ..utils.pytree import tree_sum_squares_per_chain
from . import _build
from .fused_adaptive import _check_args
from .gp_rk4 import _rk4_bwd_plain, _rk4_fwd_plain, _steps, _stream


def _elu(a):
    return torch.where(a > 0, a, torch.exp(a) - 1.0)


def _elu_deriv(a):
    return torch.where(a > 0, torch.ones_like(a), torch.exp(a))


def _hidden(w, y):
    """(a1, h1, a2) at the points y (C, N, 2) of chain-batched weights
    w = (w1, b1, w2, b2, w3, b3)."""
    w1, b1, w2, b2 = w[:4]
    a1 = (w1[:, None, 0, :] * y[..., 0:1] + w1[:, None, 1, :] * y[..., 1:2]
          + b1[:, None, :])                              # (C, N, H)
    h1 = _elu(a1)
    a2 = torch.matmul(h1, w2) + b2[:, None, :]
    return a1, h1, a2


def _make_rhs(w):
    def rhs(y):
        _, _, a2 = _hidden(w, y)
        return torch.matmul(_elu(a2), w[4]) + w[5][:, None, :]

    return rhs


def _make_rhs_vjp(w):
    """(y, cot) -> (ybar, the 6 weight cotangents), all per chain."""
    w1, _, w2, _, w3, _ = w

    def rhs_vjp(y, cot):
        a1, h1, a2 = _hidden(w, y)
        h2 = _elu(a2)
        gb3 = cot.sum(dim=1)                                   # (C, 2)
        gw3 = torch.matmul(h2.transpose(1, 2), cot)            # (C, H, 2)
        a2b = torch.matmul(cot, w3.transpose(1, 2)) * _elu_deriv(a2)
        gb2 = a2b.sum(dim=1)
        gw2 = torch.matmul(h1.transpose(1, 2), a2b)            # (C, H, H)
        a1b = torch.matmul(a2b, w2.transpose(1, 2)) * _elu_deriv(a1)
        gb1 = a1b.sum(dim=1)
        gw1 = torch.matmul(y.transpose(1, 2), a1b)             # (C, 2, H)
        ybar = torch.matmul(a1b, w1.transpose(1, 2))           # (C, N, 2)
        return ybar, (gw1, gb1, gw2, gb2, gw3, gb3)

    return rhs_vjp


def _flat(params):
    """Layer list -> (w1, b1, w2, b2, w3, b3)."""
    return tuple(layer[k] for layer in params for k in ("w", "b"))


# ---------------------------------------------------------------------------
# K6 / K7 and their plain versions
# ---------------------------------------------------------------------------

def mlp_rk4_fwd_plain(w, x0, dts):
    """Plain version of K6, on any device and dtype: trajectories
    (T, C, N, 2) of the MLP field with chain-batched weights
    w = (w1, b1, w2, b2, w3, b3) from the shared x0 (N, 2)."""
    x0b = x0.to(w[0].dtype).expand(w[0].shape[0], *x0.shape[-2:])
    return _rk4_fwd_plain(_make_rhs(w), x0b, dts)


def mlp_rk4_bwd_plain(w, ys, g, dts):
    """Plain version of K7: (the 6 weight cotangents, lbar (C, N, 2)) for
    the trajectory ys and its cotangent g, both (T, C, N, 2); lbar is the
    per-chain x0 cotangent including g[0]."""
    return _rk4_bwd_plain(_make_rhs(w), _make_rhs_vjp(w), ys, g, dts,
                          tuple(torch.zeros_like(x) for x in w))


def _check_weights(w, N):
    C, H = w[0].shape[0], w[0].shape[-1]
    f32 = torch.float32
    shapes = {"w1": (C, 2, H), "b1": (C, H), "w2": (C, H, H), "b2": (C, H),
              "w3": (C, H, 2), "b3": (C, 2)}
    _check_args(w[0].device, **{name: (x, shape, f32) for (name, shape), x
                                in zip(shapes.items(), w)})
    return C, H, _build.load_library("mlp_rk4", (N, H))


def _launch_fwd(w, x0, dts):
    N, T = x0.shape[0], dts.shape[0] + 1
    C, H, lib = _check_weights(w, N)
    dev = w[0].device
    _check_args(dev, x0=(x0, (N, 2), torch.float32),
                dts=(dts, (T - 1,), torch.float32))
    ys = torch.empty((T, C, N, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.mlp_rk4_fwd(*(x.data_ptr() for x in w), x0.data_ptr(),
                                 dts.data_ptr(), C, T, ys.data_ptr(),
                                 _stream(dev))
    _build.check(status, "mlp_rk4_fwd")
    _build.launch_counts["mlp_rk4_fwd"] += 1
    return ys


def _launch_bwd(w, ys, g, dts):
    T, N = ys.shape[0], ys.shape[2]
    C, H, lib = _check_weights(w, N)
    dev = w[0].device
    g = g.to(torch.float32).contiguous()
    f32 = torch.float32
    _check_args(dev, ys=(ys, (T, C, N, 2), f32), g=(g, (T, C, N, 2), f32),
                dts=(dts, (T - 1,), f32))
    wbar = tuple(torch.empty_like(x) for x in w)
    lbar = torch.empty((C, N, 2), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        status = lib.mlp_rk4_bwd(*(x.data_ptr() for x in w), dts.data_ptr(),
                                 ys.data_ptr(), g.data_ptr(), C, T,
                                 *(x.data_ptr() for x in wbar),
                                 lbar.data_ptr(), _stream(dev))
    _build.check(status, "mlp_rk4_bwd")
    _build.launch_counts["mlp_rk4_bwd"] += 1
    return wbar, lbar


def mlp_rk4_fwd(w, x0, dts):
    """K6 for CUDA tensors, its plain version for CPU tensors."""
    if w[0].is_cuda:
        return _launch_fwd(w, x0, dts)
    if w[0].device.type != "cpu":
        raise ValueError(f"unsupported device {w[0].device}")
    return mlp_rk4_fwd_plain(w, x0, dts)


def mlp_rk4_bwd(w, ys, g, dts):
    """K7 for CUDA tensors, its plain version for CPU tensors."""
    if w[0].is_cuda:
        return _launch_bwd(w, ys, g, dts)
    if w[0].device.type != "cpu":
        raise ValueError(f"unsupported device {w[0].device}")
    return mlp_rk4_bwd_plain(w, ys, g, dts)


class _Trajectory(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, dts, *w):
        ys = mlp_rk4_fwd(w, x0, dts)
        ctx.save_for_backward(dts, ys, *w)
        return ys

    @staticmethod
    def backward(ctx, g):
        dts, ys, *w = ctx.saved_tensors
        wbar, lbar = mlp_rk4_bwd(tuple(w), ys, g, dts)
        # x0 is shared by the chains
        return (lbar.sum(dim=0), None) + tuple(wbar)


def mlp_rk4_trajectory(params, x0, ts):
    """rk4 (3/8 rule) trajectories of the MLP field for C chains on the
    output grid ts, differentiable with respect to the weights and x0
    through the hand-written backward.

    params: the layer list [{'w', 'b'}] of sizes [2, H, H, 2] with a
    leading chain axis C; x0 (N, 2) shared; ts (T,).  Returns
    (T, C, N, 2) float32.  CUDA tensors launch K6 forward and K7
    backward; CPU tensors take their plain versions.
    """
    w = tuple(x.to(torch.float32).contiguous() for x in _flat(params))
    dev = w[0].device
    if w[0].is_cuda:
        full_f32_matmul()
    return _Trajectory.apply(
        x0.to(device=dev, dtype=torch.float32).contiguous(),
        _steps(ts, dev), *w)


def make_fused_mlp_potential(x0, ts, X, reg: float = 0.5):
    """MLP posterior potential of a chain batch, SSE + reg * sum p^2,
    through the fused kernels; term by term the JAX package's
    `make_fused_mlp_potential`.  Returns potential_batch(params) -> (C,)
    for the chain-batched layer list."""
    def potential_batch(params):
        dev = params[0]["w"].device
        Xd = torch.as_tensor(X).to(device=dev, dtype=torch.float32)
        traj = mlp_rk4_trajectory(params, x0, ts)
        xode = traj.permute(1, 2, 0, 3)                     # (C, N, T, 2)
        loss = ((Xd[None] - xode) ** 2).sum(dim=(1, 2, 3))
        return loss + reg * tree_sum_squares_per_chain(params)

    return potential_batch
