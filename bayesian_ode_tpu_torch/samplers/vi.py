"""Automatic-differentiation variational inference (ADVI).

Counterpart of `bayesian_ode_tpu/samplers/vi.py` (Kucukelbir et al. 2017):
fit a Gaussian q(theta) = N(mu, L L^T), mean-field (diagonal L) or full
rank (dense lower L), by stochastic gradient ascent on the
reparameterized ELBO, each step's `sample_size` Monte-Carlo draws
evaluated in one batch-potential call.  The optimizer is optax's
`adam(learning_rate)` written out (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0), and the JAX package's `lax.scan` over steps is a Python
loop.  The potential is U = -log posterior (unnormalized), so the ELBO is
a lower bound on log Z up to the posterior's missing normalizer.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..utils.pytree import ravel_pytree

__all__ = ["ADVIResult", "fit_advi", "sample_advi", "advi_log_prob"]


class ADVIResult(NamedTuple):
    """Fitted Gaussian variational posterior q(theta) = N(mu, L L^T)."""
    mean: Any                 # variational mean, the position's tree
    mu: torch.Tensor          # (D,) flat variational mean
    scale_tril: torch.Tensor  # (D, D) lower Cholesky factor of the covariance
    elbo_trace: torch.Tensor  # (num_steps,) per-step MC ELBO estimate
    final_elbo: torch.Tensor  # mean ELBO over the last 10% of steps
    family: str               # "meanfield" | "fullrank"


def _diag_index(d: int, device) -> torch.Tensor:
    """Positions of the diagonal in the row-major packed lower triangle."""
    return torch.cumsum(torch.arange(1, d + 1, device=device), 0) - 1


def _unpack_scale(family: str, rho: torch.Tensor, d: int) -> torch.Tensor:
    """rho -> lower Cholesky scale.  meanfield: rho (D,) log-sigmas;
    fullrank: rho (D(D+1)/2,) the row-major packed lower triangle with
    the diagonal in log space."""
    if family == "meanfield":
        return torch.diag(torch.exp(rho))
    rows, cols = torch.tril_indices(d, d, device=rho.device)
    L = torch.zeros((d, d), dtype=rho.dtype, device=rho.device)
    L = L.index_put((rows, cols), rho)
    diag = torch.diagonal(L)
    return L - torch.diag(diag) + torch.diag(torch.exp(diag))


def _log_diag(family: str, rho: torch.Tensor, d: int) -> torch.Tensor:
    """log diag(L) without building L."""
    if family == "meanfield":
        return rho
    return rho[_diag_index(d, rho.device)]


def _gaussian_logpdf(z, mu, scale_tril):
    """log N(z | mu, L L^T) for z (..., D)."""
    d = mu.shape[0]
    w = torch.linalg.solve_triangular(scale_tril, (z - mu)[..., None],
                                      upper=False)[..., 0]
    return (-0.5 * d * math.log(2.0 * math.pi)
            - torch.log(torch.diagonal(scale_tril)).sum()
            - 0.5 * (w * w).sum(dim=-1))


def _gaussian_logpdf_diag(z, mu, log_sigma):
    """The diagonal-covariance logpdf, O(D)."""
    d = mu.shape[0]
    w = (z - mu) * torch.exp(-log_sigma)
    return (-0.5 * d * math.log(2.0 * math.pi)
            - log_sigma.sum() - 0.5 * (w * w).sum(dim=-1))


def fit_advi(generator: torch.Generator,
             potential_fn: Optional[Callable], init_position,
             num_steps: int = 2000, *, sample_size: int = 8,
             family: str = "meanfield", learning_rate: float = 1e-2,
             init_scale: float = 0.1, stl: bool = False,
             potential_batch: Optional[Callable] = None) -> ADVIResult:
    """Fit a Gaussian variational approximation to exp(-U).

    potential_fn: one chain's U(theta), evaluated draw by draw; or
      `potential_batch` (the batch-potential contract: leaves with a
      leading draw axis S -> (S,)), one call a step.
    init_position: one chain's tree; its flattened value starts mu.
    family: "meanfield" (diagonal) or "fullrank" (dense lower Cholesky).
    init_scale: the initial standard deviation of every coordinate.
    stl: the sticking-the-landing estimator (Roeder, Wu & Duvenaud 2017):
      -log q(z) pathwise with the variational parameters inside log q
      held constant; the default is the analytic Gaussian entropy.
    """
    if family not in ("meanfield", "fullrank"):
        raise ValueError(f"unknown family {family!r}")
    if potential_fn is None and potential_batch is None:
        raise ValueError("need potential_fn or potential_batch")
    vec0, unravel = ravel_pytree(init_position)
    vec0 = vec0.detach()
    d, dtype, dev = vec0.shape[0], vec0.dtype, vec0.device

    if potential_batch is not None:
        def u_batch(zs):                                  # (S, D) -> (S,)
            return potential_batch(unravel(zs))
    else:
        def u_batch(zs):
            return torch.stack([potential_fn(unravel(z)) for z in zs])

    if family == "meanfield":
        rho = torch.full((d,), math.log(init_scale), dtype=dtype, device=dev)
    else:
        rho = torch.zeros((d * (d + 1)) // 2, dtype=dtype, device=dev)
        rho[_diag_index(d, dev)] = math.log(init_scale)
    ent_const = 0.5 * d * (1.0 + math.log(2.0 * math.pi))

    def elbo(mu, rho, eps):
        if family == "meanfield":
            zs = mu[None, :] + eps * torch.exp(rho)[None, :]
        else:
            zs = mu[None, :] + eps @ _unpack_scale(family, rho, d).T
        e_neg_u = -u_batch(zs).mean()
        if stl:
            sg_mu, sg_rho = mu.detach(), rho.detach()
            if family == "meanfield":
                logq = _gaussian_logpdf_diag(zs, sg_mu, sg_rho)
            else:
                logq = _gaussian_logpdf(
                    zs, sg_mu, _unpack_scale(family, sg_rho, d))
            return e_neg_u - logq.mean()
        return e_neg_u + ent_const + _log_diag(family, rho, d).sum()

    # optax.adam on the negated ELBO gradient
    b1, b2, eps_adam = 0.9, 0.999, 1e-8
    params = [vec0.clone(), rho]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    trace = []
    for count in range(1, num_steps + 1):
        eps = torch.randn((sample_size, d), generator=generator, dtype=dtype,
                          device=dev)
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in params]
            value = elbo(*leaves, eps)
            grads = torch.autograd.grad(value, leaves)
        trace.append(value.detach())
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        for i, g in enumerate(grads):
            g = -g
            m[i] = (1 - b1) * g + b1 * m[i]
            v[i] = (1 - b2) * g ** 2 + b2 * v[i]
            update = (m[i] / bc1) / (torch.sqrt(v[i] / bc2) + eps_adam)
            params[i] = params[i] + -learning_rate * update
    mu, rho = params
    scale = _unpack_scale(family, rho, d)
    trace = torch.stack(trace)
    tail = max(1, num_steps // 10)
    return ADVIResult(mean=unravel(mu), mu=mu, scale_tril=scale,
                      elbo_trace=trace, final_elbo=trace[-tail:].mean(),
                      family=family)


def sample_advi(result: ADVIResult, generator: torch.Generator,
                num_samples: int):
    """`num_samples` draws from q with a leading draw axis, ready for the
    batched samplers and the batch potentials."""
    _, unravel = ravel_pytree(result.mean)
    eps = torch.randn((num_samples, result.mu.shape[0]), generator=generator,
                      dtype=result.mu.dtype, device=result.mu.device)
    if result.family == "meanfield":
        zs = result.mu[None, :] + eps * torch.diagonal(result.scale_tril)
    else:
        zs = result.mu[None, :] + eps @ result.scale_tril.T
    return unravel(zs)


def advi_log_prob(result: ADVIResult, position) -> torch.Tensor:
    """log q(theta) of the fitted Gaussian at one chain's position."""
    vec, _ = ravel_pytree(position)
    return _gaussian_logpdf(vec, result.mu, result.scale_tril)
