"""The spiral y^3-net field on the public fused adaptive engine.

Counterpart of `bayesian_ode_tpu/ops/spiral_dopri5.py`.  The field of the
reference spiral demo (`models/spiral.py`) with per-chain weights,

    f(y) = W2^T tanh(W1^T y^3 + b1) + b2,   y in R^2, H hidden units,

weights {'w1' (C, 2, H), 'b1' (C, H), 'w2' (C, H, 2), 'b2' (C, 2)}.  The
kernels are the engine's templates over `csrc/spiral_field.cuh`
(`SpiralDopri5Fwd` for the forward, `SpiralDopri5` for the replay: one
warp per chain, ceil(H/32) units per lane; to N = 16 one state component
a lane, with a warp's buffer in 48 KB of static shared memory; past that
`csrc/spiral_wide_field.cuh`, ceil(2N/32) components a lane and one
chain a block in dynamic shared memory, to N = 64 and H = 256 where its
block fits: a shape past those raises NotImplementedError before the
build, `_build.check_shape`); the plain field and its hand-written VJP
are below, in batched torch.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from .fused_field import (
    FusedField,
    fused_dopri5_stats,
    fused_dopri5_trajectory,
)

_KEYS = ("w1", "b1", "w2", "b2")


def _hidden(w, y):
    """(u, v) = y^3 (C, N, 1) each and h = tanh(W1^T y^3 + b1) (C, N, H)."""
    w1, b1 = w[0], w[1]
    x, yy = y[..., 0:1], y[..., 1:2]
    u, v = x * x * x, yy * yy * yy
    h = torch.tanh(w1[:, None, 0, :] * u + w1[:, None, 1, :] * v
                   + b1[:, None, :])
    return u, v, h


def _make_rhs(w):
    def rhs(y):
        _, _, h = _hidden(w, y)
        return torch.matmul(h, w[2]) + w[3][:, None, :]

    return rhs


def _make_rhs_vjp(w):
    """(y, cot) -> (ybar, (gw1, gb1, gw2, gb2)), all per chain."""
    w1, w2 = w[0], w[2]

    def rhs_vjp(y, cot):
        u, v, h = _hidden(w, y)
        gb2 = cot.sum(dim=1)                                   # (C, 2)
        gw2 = torch.matmul(h.transpose(1, 2), cot)             # (C, H, 2)
        hb = torch.matmul(cot, w2.transpose(1, 2))             # (C, N, H)
        a1b = hb * (1.0 - h * h)               # tanh'(a) = 1 - tanh^2
        gb1 = a1b.sum(dim=1)
        gw1 = torch.matmul(torch.cat([u, v], dim=-1).transpose(1, 2), a1b)
        # d(y^3)/dy = 3 y^2
        ybar = 3.0 * y * y * torch.matmul(a1b, w1.transpose(1, 2))
        return ybar, (gw1, gb1, gw2, gb2)

    return rhs_vjp


def _shapes(w):
    C, H = w[0].shape[0], w[0].shape[-1]
    return (C, 2, H), (C, H), (C, H, 2), (C, 2)


@lru_cache(maxsize=None)
def spiral_field() -> FusedField:
    """The spiral field registered with the fused engine (H is read from
    the weights)."""
    return FusedField(
        name="spiral", n_wbar=4, make_rhs=_make_rhs,
        make_rhs_vjp=_make_rhs_vjp, rhs_ref=lambda w, pts: _make_rhs(w)(pts),
        shapes=_shapes, width=lambda w: w[0].shape[-1])


def _weights(params):
    return tuple(params[k] for k in _KEYS)


def spiral_dopri5_trajectory(params, x0, ts, rtol=1e-7, atol=1e-9, **opts):
    """Adaptive trajectories (T, C, N, 2) of the per-chain spiral field,
    differentiable with respect to params and x0 (N, 2).  `opts` as
    `fused_dopri5_trajectory` (store_steps, controller, method, ...)."""
    return fused_dopri5_trajectory(spiral_field(), _weights(params), x0, ts,
                                   rtol=rtol, atol=atol, **opts)


def spiral_dopri5_solve_stats(params, x0, ts, **opts):
    """(trajectory, stats): `n_iterations` is each chain's accepted-step
    count, the quantity `store_steps` must cover."""
    return fused_dopri5_stats(spiral_field(), _weights(params), x0, ts,
                              **opts)


def make_fused_spiral_potential_dopri5(x0, ts, X, reg: float = 0.5,
                                       rtol=1e-7, atol=1e-9,
                                       max_steps=100_000, store_steps=128,
                                       controller="i"):
    """Spiral posterior potential of a chain batch, SSE + reg * sum p^2,
    with the solve at adaptive dopri5 tolerance through the fused kernels.
    X is (N, T, 2).  Returns potential_batch(params) -> (C,) in float32."""
    def potential_batch(params):
        traj = spiral_dopri5_trajectory(
            params, x0, ts, rtol=rtol, atol=atol, max_steps=max_steps,
            store_steps=store_steps, controller=controller)
        Xd = torch.as_tensor(X).to(device=traj.device, dtype=traj.dtype)
        xode = traj.permute(1, 2, 0, 3)                     # (C, N, T, 2)
        loss = ((Xd[None] - xode) ** 2).sum(dim=(1, 2, 3))
        l2 = sum(params[k].to(torch.float32).reshape(params[k].shape[0], -1)
                 .pow(2).sum(dim=1) for k in _KEYS)
        return loss + reg * l2

    return potential_batch
