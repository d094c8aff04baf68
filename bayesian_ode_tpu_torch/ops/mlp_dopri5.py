"""Differentiable whole-solve fused dopri5 for the MLP field.

Counterpart of `bayesian_ode_tpu/ops/mlp_dopri5.py`: the MLP field

    f(x) = W3^T elu(W2^T elu(W1^T x + b1) + b2) + b3,   x in R^2, H hidden

(BASELINE config 3, the Van der Pol NN mean-function baseline) registered
with the public fused engine (`ops/fused_field.py`).  The kernels are the
engine's templates over `csrc/mlp_field.cuh::MLPDopri5Fwd` (the forward)
and `MLPDopri5` (the backward): one warp per chain, one hidden unit and
one state component per lane to H = 32 and N = 16, and past those
`csrc/mlp_wide_field.cuh`'s (ceil(H/32) units a lane, W2 in shared
memory).  The card takes H <= 128 at N <= 16 and H <= 64 at N <= 32; a
wider field raises NotImplementedError there before any build
(`_build.check_shape`, ROADMAP queue 1 item 19).  The plain field and
its VJP are those of `ops/mlp_rk4.py`.  The weights stay in the
layer-list layout w1 (C, 2, H), b1 (C, H), w2 (C, H, H), b2 (C, H),
w3 (C, H, 2), b3 (C, 2), and so do their cotangents.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..utils.pytree import tree_map, tree_sum_squares_per_chain
from .fused_field import (
    FusedField,
    fused_dopri5_stats,
    fused_dopri5_trajectory,
)
from .mlp_rk4 import _flat, _make_rhs, _make_rhs_vjp


@lru_cache(maxsize=None)
def mlp_field(H: int) -> FusedField:
    """The MLP field of hidden width H registered with the fused engine."""

    def shapes(w):
        C = w[0].shape[0]
        return ((C, 2, H), (C, H), (C, H, H), (C, H), (C, H, 2), (C, 2))

    return FusedField(
        name="mlp", n_wbar=6, make_rhs=_make_rhs, make_rhs_vjp=_make_rhs_vjp,
        rhs_ref=lambda w, pts: _make_rhs(w)(pts), shapes=shapes,
        width=lambda w: w[0].shape[-1])


def _field_and_weights(params):
    w = _flat(params)
    return mlp_field(int(w[0].shape[-1])), w


def mlp_dopri5_trajectory(params, x0, ts, rtol=1e-7, atol=1e-9, **opts):
    """Adaptive trajectories (T, C, N, 2) of the MLP field, differentiable
    with respect to the layer list `params` (sizes [2, H, H, 2] with a
    leading chain axis C) and x0 (N, 2).  `opts` as
    `fused_dopri5_trajectory` (store_steps, controller, method, ...)."""
    field, w = _field_and_weights(params)
    return fused_dopri5_trajectory(field, w, x0, ts, rtol=rtol, atol=atol,
                                   **opts)


def mlp_dopri5_solve_stats(params, x0, ts, rtol=1e-7, atol=1e-9, **opts):
    """(trajectory, stats): `n_iterations` is each chain's accepted-step
    count, the quantity `store_steps` must cover."""
    field, w = _field_and_weights(params)
    return fused_dopri5_stats(field, w, x0, ts, rtol=rtol, atol=atol, **opts)


def make_fused_mlp_potential_dopri5(x0, ts, X, reg: float = 0.5, rtol=1e-7,
                                    atol=1e-9, max_steps=100_000,
                                    store_steps=128, controller="i"):
    """MLP posterior potential of a chain batch, SSE + reg * sum p^2, with
    the solve at adaptive dopri5 tolerance through the fused kernels; term
    by term the JAX package's `make_fused_mlp_potential_dopri5`.  X is
    (N, T, 2).  Returns potential_batch(params) -> (C,) in float32."""
    def potential_batch(params):
        traj = mlp_dopri5_trajectory(params, x0, ts, rtol=rtol, atol=atol,
                                     max_steps=max_steps,
                                     store_steps=store_steps,
                                     controller=controller)
        Xd = torch.as_tensor(X).to(device=traj.device, dtype=traj.dtype)
        xode = traj.permute(1, 2, 0, 3)                     # (C, N, T, 2)
        loss = ((Xd[None] - xode) ** 2).sum(dim=(1, 2, 3))
        return loss + reg * tree_sum_squares_per_chain(
            tree_map(lambda x: x.to(torch.float32), params))

    return potential_batch
