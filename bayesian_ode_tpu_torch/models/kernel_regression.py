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


class GPLogDensity(NamedTuple):
    """Normalized log-density split of the GP-ODE model (counterpart of the
    JAX package's `GPLogDensity`).  Every callable takes params with a
    leading chain axis C, {'U': (C, M^2, D), 'logsn': (C, D)}, the
    batch-potential contract: one batched solve a call."""
    log_lik: Callable        # params -> (C,) normalized Gaussian loglik
    log_prior: Callable      # params -> (C,) normalized log prior
    pointwise_log_lik: Callable  # params -> (C, N*T) per-(traj, time) loglik
    potential: Callable      # params -> (C,) -(log_lik + log_prior)
    sample_prior: Callable   # (generator, n) -> {'U': (n,P,D), 'logsn': (n,D)}


def make_log_density_parts(static: GPVectorFieldStatic, x0, t, Y,
                           solve: Callable, *, logsn_mu: float = None,
                           logsn_sd: float = 1.0,
                           noise: float = 0.1) -> GPLogDensity:
    """The normalized log-likelihood / log-prior split of the GP-ODE
    posterior for the evidence estimators, SMC, Laplace and WAIC/PSIS-LOO
    (the JAX package's `make_log_density_parts`):

      log_lik(params) = sum_{n,t,d} log N(Y_ntd | xode_ntd, exp(logsn_d))
      log_prior       = sum_d log N(U[:, d] | 0, Kzz)
                      + sum_d log N(logsn_d | logsn_mu, logsn_sd^2)

    with every normalizer kept (log Z absolute and comparable across M),
    a proper Gaussian prior on logsn (logsn_mu defaults to log(noise)),
    and the U prior's Kzz applied to the whitened U, as the potential
    has it.  `pointwise_log_lik` groups by (trajectory, time): N*T points
    a chain, the deletion unit of PSIS-LOO.

    `solve(field, x0 (C, N, D), t, params)` integrates a chain batch with
    field(t (C,), y (C, N, D)) and gradients to the per-chain `params`
    (the driver's `_make_solve`); static, x0, t and Y set the device and
    dtype.  Full float32 matmuls on the card are the caller's
    (`full_f32_matmul`), where the JAX package passes
    Precision.HIGHEST."""
    dtype, dev = static.Z.dtype, static.Z.device
    Y = torch.as_tensor(Y).to(device=dev, dtype=dtype)
    x0 = torch.as_tensor(x0).to(device=dev, dtype=dtype)
    t = torch.as_tensor(t).to(device=dev, dtype=dtype)
    D = Y.shape[-1]
    NT = Y.shape[0] * Y.shape[1]
    P = static.Z.shape[0]
    mu0 = float(np.log(noise)) if logsn_mu is None else float(logsn_mu)
    sd0 = float(logsn_sd)
    Kzz = rbf(static.Z, static.Z, static.sf, static.ell)
    L = torch.linalg.cholesky(Kzz)
    logdet_Kzz = 2.0 * torch.log(torch.diagonal(L)).sum()
    log2pi = float(np.log(2.0 * np.pi))

    def _solve(params):
        A = torch.matmul(static.KzzinvL, params["U"])           # (C, P, D)
        C = A.shape[0]
        # the matmul form takes the chain axis as a batch axis
        xode = solve(lambda tt, y: vector_field_fast(A, static, tt, y),
                     x0.expand((C,) + tuple(x0.shape)), t, (A,))
        return xode.permute(1, 2, 0, 3)                         # (C, N, T, D)

    def pointwise_log_lik(params):
        xode = _solve(params)
        logsn = params["logsn"][:, None, None, :]
        sn2 = torch.exp(logsn) ** 2
        pt = -0.5 * (Y[None] - xode) ** 2 / sn2 - logsn - 0.5 * log2pi
        return pt.sum(dim=-1).reshape(-1, NT)

    def log_lik(params):
        return pointwise_log_lik(params).sum(dim=-1)

    def log_prior(params):
        U = params["U"]
        quad = torch.einsum("ckd,km,cmd->c", U, static.Kzzinv, U)
        lp_u = -0.5 * quad - 0.5 * D * logdet_Kzz - 0.5 * P * D * log2pi
        r = (params["logsn"] - mu0) / sd0
        lp_sn = (-0.5 * (r * r).sum(dim=-1) - D * float(np.log(sd0))
                 - 0.5 * D * log2pi)
        return lp_u + lp_sn

    def potential(params):
        return -(log_lik(params) + log_prior(params))

    def sample_prior(generator, n):
        eps = torch.randn((n, P, D), generator=generator, dtype=dtype,
                          device=dev)
        U = torch.einsum("pq,nqd->npd", L, eps)     # columns ~ N(0, Kzz)
        logsn = mu0 + sd0 * torch.randn((n, D), generator=generator,
                                        dtype=dtype, device=dev)
        return {"U": U, "logsn": logsn}

    return GPLogDensity(log_lik=log_lik, log_prior=log_prior,
                        pointwise_log_lik=pointwise_log_lik,
                        potential=potential, sample_prior=sample_prior)


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
