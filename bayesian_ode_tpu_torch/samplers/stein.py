"""Stein Variational Gradient Descent (SVGD) over particle ensembles.

Counterpart of `bayesian_ode_tpu/samplers/stein.py`: Liu & Wang (2016),

    phi(x_i) = (1/n) sum_j [ k(x_j, x_i) score(x_j) + grad_{x_j} k(x_j, x_i) ]
    x_i <- x_i + lr * phi(x_i)

with the RBF kernel and the median-heuristic bandwidth gamma =
1/(1e-8 + 2 sigma^2), sigma^2 = median(d^2) / (2 log(n+1)), the median
taken exactly up to `median_subsample` particles and on a strided subsample
above that.  Particles are flattened to (n, P) in JAX's leaf order
(`utils.pytree.ravel_pytree`), so numpy particles carry across unchanged.

phi goes to kernel K8 (`ops/svgd_phi.py`, which never forms the n x n
kernel matrix in device memory) for 4,096 particles or more on the card,
and to the matmul form `svgd_direction` otherwise (`_phi_dispatch`).  The
ensemble split over the shards of a mesh is `parallel.run_svgd_sharded`.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..models.kernel_regression import full_f32_matmul
from ..ops.svgd_phi import svgd_phi
from ..utils.pytree import ravel_pytree, tree_leaves, tree_map
from . import schedules
from .base import TransitionKernel


def _median(x):
    """The median of all entries of x as `jnp.median` takes it: the mean
    of the two middle values of an even count (torch.median returns the
    lower one), by a sort."""
    v = x.reshape(-1).sort().values
    m = v.numel()
    if m % 2:
        return v[m // 2]
    return (v[m // 2 - 1] + v[m // 2]) * 0.5


def _gamma_of_sigma(sigma, like):
    return torch.as_tensor(1.0 / (1e-8 + 2.0 * float(sigma) ** 2),
                           dtype=like.dtype, device=like.device)


def rbf_bandwidth(X, sigma: Optional[float] = None,
                  median_subsample: Optional[int] = None):
    """gamma of the RBF kernel (a 0-d tensor on X's device):
    1/(1e-8 + 2 sigma^2) when sigma is given, else the median heuristic
    sigma^2 = median(d^2) / (2 log(n+1)).

    `median_subsample=k` takes the median over the pairs of k strided rows
    X[::ceil(n/k)][:k] when n > k (a structured layout is sampled whole,
    not one corner), while log(n+1) keeps the true ensemble size.  None is
    exact over all n^2 pairs."""
    if sigma is not None:
        return _gamma_of_sigma(sigma, X)
    n = X.shape[0]
    if median_subsample is None or n <= median_subsample:
        sub = X
    else:
        stride = -(-n // median_subsample)           # ceil(n / k)
        sub = X[::stride][:median_subsample]
    h = _median(pairwise_sq_dists(sub, sub)) / (2.0 * math.log(n + 1.0))
    return 1.0 / (1e-8 + 2.0 * h)


def rbf_kernel(X, Y, sigma: Optional[float] = None):
    """K[i, j] = exp(-gamma |X_i - Y_j|^2); returns (K, gamma).  With sigma
    None the median is taken exactly over the same d2(X, Y) the kernel is
    applied to, with n = X.shape[0] in the log term."""
    d2 = pairwise_sq_dists(X, Y)
    if sigma is not None:
        gamma = _gamma_of_sigma(sigma, X)
    else:
        h = _median(d2) / (2.0 * math.log(X.shape[0] + 1.0))
        gamma = 1.0 / (1e-8 + 2.0 * h)
    return torch.exp(-gamma * d2), gamma


def pairwise_sq_dists(X, Y):
    """|x_i - y_j|^2 by the norm expansion (one matmul), clamped at 0."""
    xx = (X * X).sum(dim=1)
    yy = (Y * Y).sum(dim=1)
    cross = X @ Y.T
    return torch.clamp_min(xx[:, None] + yy[None, :] - 2.0 * cross, 0.0)


def svgd_direction(particles, scores, sigma: Optional[float] = None,
                   median_subsample: Optional[int] = None, rows=None):
    """phi(X) for particles (n, d) and scores -grad U (n, d) in the matmul
    form: sum_j grad_{x_j} K_ij = 2 gamma (x_i sum_j K_ij - sum_j K_ij x_j).
    `median_subsample` as `rbf_bandwidth`.  `rows` (m, d): phi at these
    particles only (a shard's block of the ensemble), the bandwidth still
    taken from the whole ensemble."""
    n = particles.shape[0]
    q = particles if rows is None else rows
    gamma = rbf_bandwidth(particles, sigma, median_subsample)
    K = torch.exp(-gamma * pairwise_sq_dists(q, particles))
    ksum = K.sum(dim=1)
    grad_K = 2.0 * gamma * (q * ksum[:, None] - K @ particles)
    return (K @ scores + grad_K) / n


class SVGDState(NamedTuple):
    particles: torch.Tensor                  # (n, P) flattened positions
    step: int
    accum: Optional[torch.Tensor] = None     # AdaGrad history (adagrad=True)

    @property
    def position(self):
        return self.particles


def _svgd_init(position, adagrad, unravel_ref):
    """Flatten a tree whose leaves have a leading particle axis (n, ...)
    to (n, P) and keep one particle's unravel; a (n, P) tensor is taken as
    it is."""
    if torch.is_tensor(position) and position.dim() == 2:
        unravel_ref[0] = lambda v: v
        flat = position
    else:
        flat = torch.cat([x.reshape(x.shape[0], -1)
                          for x in tree_leaves(position)], dim=1)
        unravel_ref[0] = ravel_pytree(tree_map(lambda x: x[0], position))[1]
    accum = torch.zeros_like(flat) if adagrad else None
    return SVGDState(flat, 0, accum)


def _svgd_apply(state, phi, lr, adagrad, alpha=0.9, fudge=1e-6):
    """x <- x + lr * phi, or AdaGrad-normalised per coordinate:
    hist = alpha hist + (1 - alpha) phi^2, the first step seeding
    hist = phi^2 (Liu & Wang's published step control)."""
    if not adagrad:
        return SVGDState(state.particles + lr * phi, state.step + 1, None)
    if state.step == 0:
        hist = phi * phi
    else:
        hist = alpha * state.accum + (1.0 - alpha) * phi * phi
    adj = phi / (fudge + torch.sqrt(hist))
    return SVGDState(state.particles + lr * adj, state.step + 1, hist)


def _phi_dispatch(particles, scores, sigma, use_kernel, median_subsample):
    """phi(X) through kernel K8 or the matmul form.  `use_kernel` (JAX's
    `use_pallas`): "auto" takes the kernel for 4,096 particles or more on
    the card (JAX: n >= 4096 off the CPU), "never"/"always" force the
    choice; "always" on CPU tensors takes K8's plain version."""
    if use_kernel not in ("auto", "never", "always"):
        raise ValueError(f"use_kernel must be 'auto', 'never' or 'always', "
                         f"got {use_kernel!r}")
    if particles.is_cuda:
        full_f32_matmul()
    n = particles.shape[0]
    if use_kernel == "always":
        kernel = True
    elif use_kernel == "never":
        kernel = False
    else:
        kernel = n >= 4096 and particles.is_cuda
    if not kernel:
        return svgd_direction(particles, scores, sigma, median_subsample)
    gamma = rbf_bandwidth(particles, sigma, median_subsample)
    return svgd_phi(particles, scores, gamma)


def svgd(potential_fn: Callable, step_size, sigma: Optional[float] = None,
         use_kernel: str = "auto", median_subsample: Optional[int] = 256,
         adagrad: bool = False) -> TransitionKernel:
    """SVGD kernel over a particle ensemble with a per-particle potential.

    `init` takes a tree whose leaves have a leading particle axis (n, ...),
    or a (n, P) tensor; particles are flattened to (n, P).  Scores are
    -grad potential_fn per particle (torch.func.vmap of grad_and_value);
    `info["potential"]` is the ensemble mean BEFORE the update, from the
    same pass.  `use_kernel` as `_phi_dispatch`; `median_subsample` as
    `rbf_bandwidth`; adagrad=True applies Liu & Wang's AdaGrad step
    control (`_svgd_apply`).  The generator passed to `step` is unused:
    SVGD is deterministic."""
    sched = schedules.resolve(step_size)
    unravel_ref = [lambda v: v]

    def init(position):
        return _svgd_init(position, adagrad, unravel_ref)

    def step(generator, state):
        lr = sched(state.step)
        unravel = unravel_ref[0]
        gv = torch.func.grad_and_value(lambda v: potential_fn(unravel(v)))
        grads, pots = torch.func.vmap(gv)(state.particles)
        phi = _phi_dispatch(state.particles, -grads, sigma, use_kernel,
                            median_subsample)
        new_state = _svgd_apply(state, phi, lr, adagrad)
        info = {"potential": pots.mean(), "accepted": True, "step_size": lr}
        return new_state, info

    return TransitionKernel(init, step)


def svgd_batched(potential_batch: Callable, step_size,
                 sigma: Optional[float] = None, use_kernel: str = "auto",
                 median_subsample: Optional[int] = 256,
                 adagrad: bool = False) -> TransitionKernel:
    """SVGD whose scores come from a batched potential: leaves carry a
    leading particle axis (n, ...) and the potential returns (n,), so the
    ensemble's scores are one forward and one backward pass of
    sum(potential_batch(unravel(flat))), e.g. through the fused kernels of
    `ops/gp_rk4.make_fused_gp_potential`.  Otherwise as `svgd`:
    `info["potential"]` is the pass's total over n, the ensemble mean
    before the update."""
    sched = schedules.resolve(step_size)
    unravel_ref = [lambda v: v]

    def init(position):
        return _svgd_init(position, adagrad, unravel_ref)

    def step(generator, state):
        lr = sched(state.step)
        with torch.enable_grad():
            flat = state.particles.detach().requires_grad_(True)
            total = potential_batch(unravel_ref[0](flat)).sum()
            (grads,) = torch.autograd.grad(total, [flat])
        phi = _phi_dispatch(state.particles, -grads, sigma, use_kernel,
                            median_subsample)
        new_state = _svgd_apply(state, phi, lr, adagrad)
        info = {"potential": total.detach() / state.particles.shape[0],
                "accepted": True, "step_size": lr}
        return new_state, info

    return TransitionKernel(init, step)
