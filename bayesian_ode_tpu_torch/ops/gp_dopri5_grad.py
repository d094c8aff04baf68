"""Differentiable whole-solve dopri5 for the GP field, and the fused GP
posterior potential of the main path.

Counterpart of `bayesian_ode_tpu/ops/gp_dopri5_grad.py`.
`gp_dopri5_trajectory` is the GP registration of the public engine
(`ops/gp_field.py`, `ops/fused_field.py`) at DOPRI5: the recording kernel
K2 forward and the replay kernel K3 backward, a discrete adjoint with the
step mesh frozen.  Step sizes are constants of the backward pass; the
controller's dependence on the parameters contributes O(rtol) relative
terms, below the float32 noise floor at rtol=1e-7 (the JAX package
measured its adjoint at 2.1e-4 max-rel against a float64 truth, the
generic float32 backprop at 3.1e-4).

`store_steps` bounds the accepted steps recorded per chain; a chain that
needs more makes the forward raise.
"""
from __future__ import annotations

from ..models.kernel_regression import make_batch_potential
from .fused_field import fused_dopri5_trajectory_plain
from .gp_field import gp_field, gp_field_trajectory, gp_weights


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
    return gp_field_trajectory(A, x0, ts, static, rtol=rtol, atol=atol,
                               safety=safety, ifactor=ifactor,
                               dfactor=dfactor, max_steps=max_steps,
                               store_steps=store_steps, controller=controller)


def gp_dopri5_trajectory_plain(A, x0, ts, static, rtol=1e-7, atol=1e-9,
                               safety=0.9, ifactor=10.0, dfactor=0.2,
                               max_steps=100_000, controller="i"):
    """The same trajectories from the plain forward, on any device, with
    gradients by autograd through it (step sizes detached: the frozen-mesh
    gradient computed a second, independent way)."""
    return fused_dopri5_trajectory_plain(
        gp_field(float(static.sf), float(static.ell)), gp_weights(A, static),
        x0, ts, rtol=rtol, atol=atol, safety=safety, ifactor=ifactor,
        dfactor=dfactor, max_steps=max_steps, controller=controller)


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
