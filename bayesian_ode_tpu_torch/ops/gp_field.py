"""The GP vector field registered with the public fused adaptive engine.

Counterpart of `bayesian_ode_tpu/ops/gp_field.py`.  The weights are
(A (C, M, 2), Z (M, 2)): A per chain gets the cotangent, the inducing grid
Z is shared by all chains and stays one copy in each block's shared memory
(`csrc/gp_field.cuh::GPPoint`, one thread per trajectory point; past
N = 32 or a block's shared memory `csrc/gp_wide_field.cuh::GPWidePoint`,
to N = 128 and M = 1,024), where the TPU engine replicated it per chain.  `gp_field_trajectory` takes `method="dopri5"` or `"tsit5"`.

The GP adapters of `ops/gp_dopri5.py` and `ops/gp_dopri5_grad.py` are this
registration at DOPRI5: one path, the same kernels.  The Hairer start step
uses `rbf`'s matmul form, as the JAX package's hand-written adapter does
(its `gp_field` registration uses the direct form there, so the two JAX
engines agree to O(rtol); the port's agree bit for bit).
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..models.kernel_regression import rbf
from .fused_field import (
    FusedField,
    fused_dopri5_stats,
    fused_dopri5_trajectory,
)
from .gp_dopri5 import _make_rhs, _make_rhs_vjp


@lru_cache(maxsize=None)
def gp_field(sf: float, ell: float) -> FusedField:
    """The GP field at kernel hyperparameters (sf, ell) as a registration
    of the fused engine."""

    def make_rhs(w):
        return _make_rhs(w[0], w[1], sf, ell)

    def make_rhs_vjp(w):
        vjp = _make_rhs_vjp(w[0], w[1], sf, ell)

        def rhs_vjp(y, cot):
            ybar, Abar = vjp(y, cot)
            return ybar, (Abar,)

        return rhs_vjp

    def rhs_ref(w, pts):
        return torch.matmul(rbf(pts, w[1], sf, ell), w[0])

    def shapes(w):
        C, M = w[0].shape[0], w[0].shape[1]
        return (C, M, 2), (M, 2)

    return FusedField(
        name="gp", n_wbar=1, make_rhs=make_rhs, make_rhs_vjp=make_rhs_vjp,
        rhs_ref=rhs_ref, shapes=shapes, width=lambda w: w[0].shape[1],
        scalars=(sf * sf, 0.5 / (ell * ell), 1.0 / (ell * ell)))


def gp_weights(A, static):
    """(A, Z) on A's device: the weight blocks of `gp_field`."""
    return A, static.Z.to(device=A.device)


def gp_field_trajectory(A, x0, ts, static, rtol=1e-7, atol=1e-9,
                        method="dopri5", **opts):
    """Adaptive trajectories (T, C, N, 2) of the GP field through the
    public engine, at `method` "dopri5" or "tsit5", differentiable with
    respect to A (C, M, 2) and x0 (N, 2).  `opts` as
    `fused_dopri5_trajectory`."""
    return fused_dopri5_trajectory(
        gp_field(float(static.sf), float(static.ell)), gp_weights(A, static),
        x0, ts, rtol=rtol, atol=atol, method=method, **opts)


def gp_field_solve_stats(A, x0, ts, static, method="dopri5", **opts):
    """(trajectory, stats) through the public engine: `n_iterations` sizes
    the `store_steps` gradient budget."""
    return fused_dopri5_stats(
        gp_field(float(static.sf), float(static.ell)), gp_weights(A, static),
        x0, ts, method=method, **opts)
