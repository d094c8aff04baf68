"""Laplace approximation: a Gaussian posterior and an evidence from a MAP
fit.

Counterpart of `bayesian_ode_tpu/samplers/laplace.py`.  Expand
U = -log posterior to second order at the mode theta*:

    q(theta) = N(theta*, H^{-1}),     H = grad^2 U(theta*)
    log Z    ~= -U(theta*) + D/2 log(2 pi) - 1/2 log det H

(exact when U is quadratic).  The MAP fit is `optim.lbfgs_minimize` on
one chain; the dense Hessian is `metrics.flat_hessian`, one double
backward over a D-row batch of the mode, so the potential follows the
batch-potential contract.  Through the continuous adjoint that needs a
fixed-grid solver (`ode/adjoint.py`), as the JAX package's jacrev of grad
does.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..optim.lbfgs import lbfgs_minimize
from ..utils.pytree import ravel_pytree, tree_map
from .metrics import flat_hessian

__all__ = ["LaplaceResult", "laplace_approximation", "sample_laplace"]


class LaplaceResult(NamedTuple):
    mode: Any                  # MAP point, the position's tree
    mu: torch.Tensor           # (D,) flat MAP point
    prec_chol: torch.Tensor    # (D, D) lower L with H = L L^T
    log_evidence: torch.Tensor  # Laplace log Z (up to U's normalizer)
    potential_at_mode: torch.Tensor
    value_trace: torch.Tensor  # L-BFGS per-iteration potential values
    # False when the (jittered) Hessian at the terminus is not positive
    # definite: prec_chol, log_evidence and every draw are then NaN
    hessian_pd: torch.Tensor   # () bool


def laplace_approximation(potential_batch: Callable, init_position,
                          max_iters: int = 200, *, jitter: float = 1e-8,
                          **lbfgs_kwargs) -> LaplaceResult:
    """Fit the Laplace approximation to exp(-U) from `init_position` (one
    chain's tree).  `potential_batch` maps leaves with a leading chain
    axis to (C,) potentials.  `jitter` scales an identity ridge (relative
    to the Hessian's mean diagonal) added before the Cholesky."""
    def potential(p):
        return potential_batch(tree_map(lambda x: x[None], p))[0]

    mode, value, trace, _ = lbfgs_minimize(potential, init_position,
                                           max_iters=max_iters,
                                           **lbfgs_kwargs)
    mu, _ = ravel_pytree(mode)
    d = mu.shape[0]
    hess = flat_hessian(potential_batch,
                        tree_map(lambda x: x[None], mode))[0]
    hess = 0.5 * (hess + hess.T)
    eye = torch.eye(d, dtype=mu.dtype, device=mu.device)
    ridge = jitter * torch.diagonal(hess).mean() * eye
    # a non-PD input gives a NaN lower triangle (as the JAX package's
    # Cholesky does), flagged below
    chol, info = torch.linalg.cholesky_ex(hess + ridge)
    chol = torch.where(info == 0, chol,
                       torch.tril(torch.full_like(chol, math.nan)))
    hessian_pd = torch.isfinite(chol).all()
    log_det = 2.0 * torch.log(torch.diagonal(chol)).sum()
    log_z = -value + 0.5 * d * math.log(2.0 * math.pi) - 0.5 * log_det
    return LaplaceResult(mode=mode, mu=mu, prec_chol=chol, log_evidence=log_z,
                         potential_at_mode=value, value_trace=trace,
                         hessian_pd=hessian_pd)


def sample_laplace(result: LaplaceResult, generator: torch.Generator,
                   num_samples: int):
    """Draws from N(theta*, H^{-1}) with a leading draw axis: with
    H = L L^T, theta* + L^{-T} eps."""
    _, unravel = ravel_pytree(result.mode)
    d = result.mu.shape[0]
    eps = torch.randn((d, num_samples), generator=generator,
                      dtype=result.mu.dtype, device=result.mu.device)
    zs = result.mu[:, None] + torch.linalg.solve_triangular(
        result.prec_chol.T, eps, upper=True)
    return unravel(zs.T)
