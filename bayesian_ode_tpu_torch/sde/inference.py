"""Bayesian inference for SDE models: Euler-Maruyama transition
pseudo-likelihood potentials for the samplers' contract.

Counterpart of `bayesian_ode_tpu/sde/inference.py`.  Where the ODE model
solves a trajectory and charges a Gaussian observation likelihood, the
SDE model charges the Gaussian transition density of the Euler-Maruyama
discretization between consecutive observations,

    y_{k+1} | y_k ~ N(y_k + f(t_k, y_k) dt_k,  g(t_k, y_k)^2 dt_k)

(diagonal noise), the tractable pseudo-likelihood for discretely observed
diffusions (the npde lineage's NPSDE fits drift and diffusion through
it).  `em_log_likelihood` evaluates the fields at every transition in one
call, `torch.func.vmap` over the time axis, where the JAX package vmaps.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models.kernel_regression import (
    GPVectorFieldStatic,
    full_f32_matmul,
    precompute_weights,
    rbf,
    vector_field_fast,
)
from ..utils.pytree import Tree, tree_leaves, tree_map

__all__ = [
    "em_log_likelihood",
    "make_sde_potential",
    "make_gp_sde_potential",
    "make_gp_sde_potential_batched",
]

_LOG_2PI = 1.8378770664093453


def em_log_likelihood(drift: Callable, diffusion: Callable, ts, Y: Tree):
    """Sum of Euler-Maruyama transition log-densities along observations.

    ts: (T,) observation times (strictly increasing); Y: a tree whose
    leaves carry a leading time axis (T, ...); extra axes (replicate
    trajectories, state dims) are summed over.  Diagonal noise: the
    diffusion returns a tree shaped like one observation.  The fields see
    one transition's time and state under `torch.func.vmap`.
    """
    leaf = tree_leaves(Y)[0]
    ts = torch.as_tensor(ts, device=leaf.device)
    dts = ts[1:] - ts[:-1]                        # (T-1,)
    Y0 = tree_map(lambda y: y[:-1], Y)
    Y1 = tree_map(lambda y: y[1:], Y)

    def trans(t, dt, y0, y1):
        f = drift(t, y0)
        g = diffusion(t, y0)

        def one(y0_, y1_, f_, g_):
            dt_ = dt.to(y0_.dtype)
            var = g_ * g_ * dt_
            resid = y1_ - y0_ - f_ * dt_
            return -0.5 * (resid * resid / var + torch.log(var)
                           + _LOG_2PI).sum()

        return sum(tree_leaves(tree_map(one, y0, y1, f, g)))

    return torch.func.vmap(trans)(ts[:-1], dts, Y0, Y1).sum()


def make_sde_potential(drift_of_params: Callable,
                       diffusion_of_params: Callable, ts, Y: Tree,
                       log_prior: Optional[Callable] = None) -> Callable:
    """potential(params) = -em_log_likelihood - log_prior(params): the
    samplers' one-chain potential for Bayesian drift/diffusion inference.
    drift_of_params(params) / diffusion_of_params(params) return the
    (t, y) -> tree field closures."""
    def potential(params):
        ll = em_log_likelihood(drift_of_params(params),
                               diffusion_of_params(params), ts, Y)
        lp = 0.0 if log_prior is None else log_prior(params)
        return -(ll + lp)

    return potential


def _on_static(static: GPVectorFieldStatic, x):
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.array(x))
    return x.to(device=static.Z.device, dtype=static.Z.dtype)


def make_gp_sde_potential(static: GPVectorFieldStatic, ts, Y,
                          add_prior: bool = True,
                          precision=None) -> Callable:
    """NPSDE: the nonparametric GP drift on the inducing grid (the ODE
    model's whitened kernel-regression field, params {"U": (M^2, D),
    "logsd": (D,)}) with the learnable constant diffusion exp(logsd) per
    state dimension, under the EM transition likelihood.  Y: (R, T, D)
    replicate trajectories observed at ts, in the static's device and
    dtype.  The prior is the ODE posterior's tr(U^T Kzz^{-1} U)/2.
    `precision` is accepted for the JAX signature and ignored: the port's
    float32 matmuls run in full float32 (TF32 off, `full_f32_matmul`)."""
    del precision
    Yt = _on_static(static, Y).movedim(1, 0)      # (T, R, D)
    ts = _on_static(static, ts)

    def potential(params):
        A = precompute_weights({"U": params["U"]}, static)
        sd = torch.exp(params["logsd"])          # (D,)

        def drift(t, y):
            return vector_field_fast(A, static, t, y)

        def diffusion(t, y):
            return sd.to(y.dtype).expand(y.shape)

        pot = -em_log_likelihood(drift, diffusion, ts, Yt)
        if add_prior:
            U = params["U"]
            pot = pot + torch.trace(U.T @ (static.Kzzinv @ U)) / 2.0
        return pot

    return potential


def make_gp_sde_potential_batched(static: GPVectorFieldStatic, ts, Y,
                                  add_prior: bool = True,
                                  precision=None) -> Callable:
    """`make_gp_sde_potential` for a whole chain batch in one call, the
    batch-potential contract of `samplers.*_batched`: params leaves carry
    a leading chain axis, {"U": (C, M^2, D), "logsd": (C, D)}, and the
    return is the (C,) potential vector.

    The EM likelihood needs the drift only at the data points, and
    K(X, Z) is shared by every chain, so the batch's drifts are

        F = K(X, Z) @ (Kzz^{-1} L) @ U_c   for all c at once,

    one (N, M^2) x (M^2, C*D) product (N = R*(T-1) transitions) and an
    elementwise tail, with no solve.  `precision` is ignored, as in
    `make_gp_sde_potential`; on the card the float32 products run with
    TF32 off."""
    del precision
    if static.Z.is_cuda:
        full_f32_matmul()
    Y = _on_static(static, Y)                      # (R, T, D)
    ts = _on_static(static, ts)
    R, T, D = Y.shape
    X0 = Y[:, :-1, :].reshape(-1, D)               # (N, D), N = R*(T-1)
    X1 = Y[:, 1:, :].reshape(-1, D)
    dts = (ts[1:] - ts[:-1]).expand(R, T - 1).reshape(-1)   # (N,)
    Kxz = rbf(X0, static.Z, static.sf, static.ell)           # (N, M^2)
    dY = X1 - X0                                   # (N, D)

    def potential(params):
        U = params["U"]                            # (C, M^2, D)
        A = torch.einsum("ij,cjd->cid", static.KzzinvL, U)
        F = torch.einsum("ni,cid->cnd", Kxz, A)
        var = (torch.exp(2.0 * params["logsd"])[:, None, :]
               * dts[None, :, None])               # (C, N, D)
        resid = dY[None] - F * dts[None, :, None]
        ll = -0.5 * (resid * resid / var + torch.log(var)
                     + _LOG_2PI).sum(dim=(1, 2))   # (C,)
        pot = -ll
        if add_prior:
            pot = pot + 0.5 * torch.einsum("cid,ij,cjd->c", U,
                                           static.Kzzinv, U)
        return pot

    return potential
