"""Riemannian metrics for MMALA (SoftAbs, Hessian, identity) and the dense
Hessian they are built on.

Counterpart of `bayesian_ode_tpu/samplers/metrics.py`, over the
batch-potential contract: a metric maps positions with a leading chain
axis C to (C, P, P) matrices on each chain's flattened parameter vector.
The JAX package takes `jax.hessian` (forward over reverse); here the
Hessian is reverse over reverse, since torch's forward mode cannot pass
through an `autograd.Function` without a jvp (the continuous adjoint's).
SoftAbs's full metric is V diag(lam') V^T and its inverse the true
inverse, the JAX package's two fixes of the reference (metrics.py:53-54,
66-68).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..utils.pytree import ravel_pytree, tree_leaves, tree_map


def flat_hessian(potential_batch: Callable, position) -> torch.Tensor:
    """(C, P, P) dense Hessians of each chain's potential on its flattened
    parameters, by one double backward: each chain is replicated P times
    (C P rows), the batched gradient is taken with a graph, and the sum
    over rows r of g_r[r mod P] is differentiated once.  Row i of chain
    c's Hessian lands in its i-th replica, since each row's gradient
    depends on that row's parameters alone."""
    _, unravel = ravel_pytree(tree_map(lambda x: x[0], position))
    vecs = torch.cat([x.reshape(x.shape[0], -1)
                      for x in tree_leaves(position)], dim=1)     # (C, P)
    C, P = vecs.shape
    with torch.enable_grad():
        rows = vecs.detach().repeat_interleave(P, dim=0).requires_grad_(True)
        pots = potential_batch(unravel(rows))
        (g,) = torch.autograd.grad(pots.sum(), rows, create_graph=True)
        eye = torch.eye(P, dtype=g.dtype, device=g.device).repeat(C, 1)
        (H,) = torch.autograd.grad((g * eye).sum(), rows)
    return H.reshape(C, P, P)


def softabs_metric(potential_batch: Callable, softabs_coeff: float = 1.0
                   ) -> Callable[..., Dict[str, torch.Tensor]]:
    """SoftAbs metric (Betancourt, arXiv:1212.4693): eigendecompose each
    chain's Hessian and regularize its eigenvalues with
    lam' = lam / tanh(alpha lam).  `sqrtMetric` and `sqrtinvMetric` carry
    `eigh`'s column signs; Metric, invMetric and log_det_sqrt do not."""

    def metric(position):
        H = flat_hessian(potential_batch, position)
        lam, V = torch.linalg.eigh(H)
        lam_m = lam / torch.tanh(lam * softabs_coeff)
        Vt = V.transpose(-1, -2)
        return {
            "hess": H,
            "Metric": (V * lam_m[:, None, :]) @ Vt,
            "invMetric": (V / lam_m[:, None, :]) @ Vt,
            "sqrtMetric": V * torch.sqrt(lam_m)[:, None, :],
            "sqrtinvMetric": V / torch.sqrt(lam_m)[:, None, :],
            "log_det_sqrt": 0.5 * torch.log(lam_m).sum(dim=-1),
        }

    return metric


def hessian_metric(potential_batch: Callable, rcond: float = 1e-6,
                   identity_factor: float = 1e-8
                   ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Raw-Hessian metric: its pseudo-inverse and a jittered Cholesky
    square root of that (the reference's metrics.py:104-137)."""

    def metric(position):
        H = flat_hessian(potential_batch, position)
        Hinv = torch.linalg.pinv(H, rtol=rcond, hermitian=False)
        eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
        L = torch.linalg.cholesky(Hinv + identity_factor * eye)
        return {"Metric": H, "invMetric": Hinv, "sqrtinvMetric": L}

    return metric


def identity_metric(size: int) -> Callable[..., Dict[str, torch.Tensor]]:
    """The Euclidean metric: MMALA becomes MALA."""

    def metric(position):
        x = tree_leaves(position)[0]
        eye = torch.eye(size, dtype=x.dtype, device=x.device).expand(
            x.shape[0], size, size)
        return {"Metric": eye, "invMetric": eye, "sqrtinvMetric": eye}

    return metric
