"""Differentiable whole-solve dopri5 for the GP field, and the fused GP
posterior potential of the main path.

Counterpart of `bayesian_ode_tpu/ops/gp_dopri5_grad.py`.
`gp_dopri5_trajectory` is a `torch.autograd.Function` whose forward is the
recording kernel K2 and whose backward is the replay kernel K3
(`ops/fused_adaptive.py`): a discrete adjoint with the step mesh frozen.
Step sizes are constants of the backward pass; the controller's
dependence on the parameters contributes O(rtol) relative terms, below
the float32 noise floor at rtol=1e-7 (the JAX package measured its
adjoint at 2.1e-4 max-rel against a float64 truth, the generic float32
backprop at 3.1e-4).

`store_steps` bounds the accepted steps recorded per chain; a chain that
needs more makes the forward raise.
"""
from __future__ import annotations

import torch

from ..models.kernel_regression import (
    full_f32_matmul,
    make_batch_potential,
)
from . import fused_adaptive as fa
from .gp_dopri5 import _check_controller, _pack_initial


def _prepare(A, x0, ts, Z):
    dev = A.device
    return (A.to(torch.float32).contiguous(),
            x0.to(device=dev, dtype=torch.float32),
            torch.as_tensor(ts, device=dev).to(torch.float32).contiguous(),
            Z.to(device=dev, dtype=torch.float32).contiguous())


class _Trajectory(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, x0, ts, Z, sf, ell, rtol, atol, safety, ifactor,
                dfactor, max_steps, store_steps, controller):
        x0b, f0, dt0 = _pack_initial(A, x0, Z, sf, ell, rtol, atol)
        ys, _, nacc, _, _, rec = fa.fwd(
            A, Z, x0b, f0, dt0, ts, sf, ell, rtol, atol, safety, ifactor,
            dfactor, max_steps, controller, record=True,
            store_steps=store_steps)
        ctx.save_for_backward(A, Z, ts, rec, nacc)
        ctx.sf, ctx.ell = sf, ell
        return ys

    @staticmethod
    def backward(ctx, g):
        A, Z, ts, rec, nacc = ctx.saved_tensors
        Abar, lbar = fa.bwd(A, Z, ts, rec, nacc, g, ctx.sf, ctx.ell)
        # x0 is shared by the chains; row 0 of the trajectory is x0 itself
        x0bar = lbar.sum(dim=0) + g[0].sum(dim=0)
        return (Abar, x0bar) + (None,) * 12


def gp_dopri5_trajectory(A, x0, ts, static, rtol=1e-7, atol=1e-9,
                         safety=0.9, ifactor=10.0, dfactor=0.2,
                         max_steps=100_000, store_steps=128,
                         controller="i"):
    """Adaptive dopri5 trajectories of the GP field, differentiable with
    respect to A and x0 through the hand-written discrete adjoint.

    A (C, M, 2), x0 (N, 2) shared, ts (T,) increasing.  Returns
    (T, C, N, 2) float32; the values equal `gp_dopri5_solve_whole`'s.
    CUDA tensors launch K2 forward and K3 backward; CPU tensors take their
    plain versions.
    """
    _check_controller(controller)
    if A.is_cuda:
        full_f32_matmul()
    A32, x0, ts, Z = _prepare(A, x0, ts, static.Z)
    return _Trajectory.apply(A32, x0, ts, Z, float(static.sf),
                             float(static.ell), float(rtol), float(atol),
                             float(safety), float(ifactor), float(dfactor),
                             int(max_steps), int(store_steps), controller)


def gp_dopri5_trajectory_plain(A, x0, ts, static, rtol=1e-7, atol=1e-9,
                               safety=0.9, ifactor=10.0, dfactor=0.2,
                               max_steps=100_000, controller="i"):
    """The same trajectories from the plain forward, on any device, with
    gradients by autograd through it (step sizes detached: the frozen-mesh
    gradient computed a second, independent way)."""
    _check_controller(controller)
    A32, x0, ts, Z = _prepare(A, x0, ts, static.Z)
    x0b, f0, dt0 = _pack_initial(A32, x0, Z, static.sf, static.ell, rtol,
                                 atol)
    return fa.fwd_plain(A32, Z, x0b, f0, dt0, ts, static.sf, static.ell,
                        rtol, atol, safety, ifactor, dfactor, max_steps,
                        controller)[0]


def make_fused_gp_potential_dopri5(static, x0, ts, Y, rtol=1e-7, atol=1e-9,
                                   max_steps=100_000, store_steps=128,
                                   controller="i"):
    """GP posterior potential of a chain batch with the solve by adaptive
    dopri5 at (rtol, atol) through the fused kernels, so SGLD/pSGLD at
    dopri5 tolerance runs fused end to end.

    Returns potential_batch(params) -> (C,) for params
    {'U': (C, M, 2), 'logsn': (C, 2)}; matches
    `models.kernel_regression.make_potential` with a dopri5 solve.
    """
    def trajectory(A):
        return gp_dopri5_trajectory(A, x0, ts, static, rtol=rtol, atol=atol,
                                    max_steps=max_steps,
                                    store_steps=store_steps,
                                    controller=controller)

    return make_batch_potential(static, Y, trajectory)
