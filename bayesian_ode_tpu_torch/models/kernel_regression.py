"""Nonparametric GP (kernel-regression) ODE vector field on an inducing grid.

Counterpart of `bayesian_ode_tpu/models/kernel_regression.py`.  The field is

    f(X) = K(X, Z) Kzz^{-1} L U = K(X, Z) L^{-T} U

with whitened weights U (M^2, D), per-dimension log noise `logsn` and a
fixed M x M inducing grid Z.  Parameters are plain dicts of tensors,
{"U": (..., M^2, 2), "logsn": (..., 2)}; the static quantities are a
NamedTuple.  `static_from_numpy` / `params_from_numpy` take the JAX
package's arrays so that both packages compute the same thing.

Float32 matmuls on the card must run in full float32: TF32 rounding in the
right-hand side lands in the adaptive solvers' error estimates and
shrinks the step size (`full_f32_matmul`).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch


def full_f32_matmul() -> None:
    """Turn TF32 off for float32 matmuls and convolutions, and check it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest", (
        "float32 matmul precision must stay 'highest' for adaptive solves")


def rbf(X1, X2, sf, ell):
    """K = sf^2 exp(-||x/ell - x'/ell||^2 / 2), in the matmul form of the
    JAX package (X1 may carry leading batch axes)."""
    X1 = X1 / ell
    X2 = X2 / ell
    cross = torch.matmul(X1, X2.transpose(-1, -2))
    d2 = ((X1 ** 2).sum(-1)[..., :, None] + (X2 ** 2).sum(-1)[..., None, :]
          - 2.0 * cross)
    return sf ** 2 * torch.exp(-d2 / 2.0)


class GPVectorFieldStatic(NamedTuple):
    """Fixed (non-learnable) pieces of the model."""
    Z: torch.Tensor          # (M^2, 2) inducing grid
    KzzinvL: torch.Tensor    # (M^2, M^2) = Kzz^{-1} L = L^{-T}
    Kzzinv: torch.Tensor     # (M^2, M^2), used by the prior term
    sf: float
    ell: float


def make_inducing_grid(Y, M: int, device=None,
                       dtype=torch.float64) -> torch.Tensor:
    """M x M grid covering the observed data range; Y (N, T, 2)."""
    Yn = Y.detach().cpu().numpy() if torch.is_tensor(Y) else np.asarray(Y)
    xv = np.linspace(Yn[..., 0].min(), Yn[..., 0].max(), M)
    yv = np.linspace(Yn[..., 1].min(), Yn[..., 1].max(), M)
    xg, yg = np.meshgrid(xv, yv)
    grid = np.stack([xg.T.flatten(), yg.T.flatten()], axis=1)
    return torch.as_tensor(grid, dtype=dtype, device=device)


def make_static(Z, sf: float, ell: float) -> GPVectorFieldStatic:
    Kzz = rbf(Z, Z, sf, ell)
    L = torch.linalg.cholesky(Kzz)
    Kzzinv = torch.linalg.inv(Kzz)
    return GPVectorFieldStatic(Z=Z, KzzinvL=Kzzinv @ L, Kzzinv=Kzzinv,
                               sf=float(sf), ell=float(ell))


def gradient_matching_init(Y, t, static: GPVectorFieldStatic):
    """Whitened U0 from finite-difference slope regression onto the grid."""
    dt = t[1] - t[0]
    D = Y.shape[-1]
    F = ((Y[:, 1:, :] - Y[:, :-1, :]) / dt).reshape(-1, D)
    Zdata = Y[:, :-1, :].reshape(-1, D)
    Kxz = rbf(static.Z, Zdata, static.sf, static.ell)
    Kdd = rbf(Zdata, Zdata, static.sf, static.ell)
    eye = torch.eye(Kdd.shape[0], dtype=Kdd.dtype, device=Kdd.device)
    Kddinv = torch.linalg.inv(Kdd + 0.2 * eye)
    U0 = Kxz @ (Kddinv @ F)
    L = torch.linalg.cholesky(rbf(static.Z, static.Z, static.sf, static.ell))
    return torch.linalg.inv(L) @ U0


def init_params(Y, t, static: GPVectorFieldStatic,
                noise: float) -> Dict[str, torch.Tensor]:
    """{'U': whitened weights, 'logsn': per-dim log noise}."""
    D = Y.shape[-1]
    return {
        "U": gradient_matching_init(Y, t, static),
        "logsn": torch.full((D,), float(np.log(noise)), dtype=Y.dtype,
                            device=Y.device),
    }


def precompute_weights(params, static: GPVectorFieldStatic):
    """A = (Kzz^{-1} L) U, constant across a solve."""
    return static.KzzinvL @ params["U"]


def vector_field(params, static: GPVectorFieldStatic, t, X):
    """f(X) = K(X, Z) (Kzz^{-1} L) U for X (..., 2)."""
    return rbf(X, static.Z, static.sf, static.ell) @ static.KzzinvL \
        @ params["U"]


def vector_field_fast(A, static: GPVectorFieldStatic, t, X):
    """f(X) = K(X, Z) A with precomputed A (M^2, D)."""
    return torch.matmul(rbf(X, static.Z, static.sf, static.ell), A)


def make_potential(static: GPVectorFieldStatic, x0, t, Y,
                   odeint_fn: Callable, add_prior: bool = True) -> Callable:
    """Negative log posterior of one chain's {'U', 'logsn'}:

        sum (Y - x_ode)^2 / (2 exp(logsn)^2) + numel(Y) sum(logsn) / D
        + tr(U^T Kzz^{-1} U) / 2

    `odeint_fn(func, x0, t)` chooses the solver.  The trace prior applies
    Kzz^{-1} to the whitened U, as the reference and the JAX package do.
    add_prior=False returns the plain sum of squared errors.
    """
    D = Y.shape[-1]
    numel = Y.numel()

    def potential(params):
        A = precompute_weights(params, static)
        xode = odeint_fn(lambda tt, X: vector_field_fast(A, static, tt, X),
                         x0, t)
        xode = xode.movedim(0, 1)            # (T, N, 2) -> (N, T, 2)
        if not add_prior:
            return ((Y - xode) ** 2).sum()
        sn2 = torch.exp(params["logsn"]) ** 2
        loss = ((Y - xode) ** 2 / (2.0 * sn2)).sum()
        loss = loss + numel * params["logsn"].sum() / D
        U = params["U"]
        loss = loss + torch.trace(U.T @ (static.Kzzinv @ U)) / 2.0
        return loss

    return potential


def static_from_numpy(Z, KzzinvL, Kzzinv, sf, ell, device="cpu",
                      dtype=torch.float64) -> GPVectorFieldStatic:
    """The JAX package's static quantities (numpy arrays) as the port's."""
    def conv(x):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return GPVectorFieldStatic(Z=conv(Z), KzzinvL=conv(KzzinvL),
                               Kzzinv=conv(Kzzinv), sf=float(sf),
                               ell=float(ell))


def params_from_numpy(params, device="cpu",
                      dtype=torch.float64) -> Dict[str, torch.Tensor]:
    """A parameter dict of numpy arrays as a dict of tensors."""
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            for k, v in params.items()}


def make_batch_potential(static: GPVectorFieldStatic, Y,
                         trajectory: Callable) -> Callable:
    """The posterior potential of `make_potential` over a chain batch, for
    the fused engines: `trajectory(A)` maps the weights A (C, M, 2) to the
    trajectories (T, C, N, 2) at the observation times.  Returns
    potential_batch(params) -> (C,) for params {'U': (C, M, 2),
    'logsn': (C, 2)}, in float32."""
    dev = static.Z.device
    Y = torch.as_tensor(Y).to(device=dev, dtype=torch.float32)
    D = Y.shape[-1]
    numel = Y.numel()
    KzzinvL = static.KzzinvL.to(torch.float32)
    Kzzinv = static.Kzzinv.to(torch.float32)

    def potential_batch(params):
        U = params["U"].to(torch.float32)                  # (C, M, 2)
        logsn = params["logsn"].to(torch.float32)          # (C, 2)
        A = torch.einsum("mk,ckd->cmd", KzzinvL, U)
        xode = trajectory(A).permute(1, 2, 0, 3)           # (C, N, T, 2)
        sn2 = torch.exp(logsn) ** 2
        resid = (Y[None] - xode) ** 2
        loss = (resid / (2.0 * sn2[:, None, None, :])).sum(dim=(1, 2, 3))
        loss = loss + numel * logsn.sum(dim=-1) / D
        loss = loss + torch.einsum("ckd,km,cmd->c", U, Kzzinv, U) / 2.0
        return loss

    return potential_batch
