"""Adaptive-tempered Sequential Monte Carlo (SMC) sampler.

Counterpart of `bayesian_ode_tpu/samplers/smc.py` (Del Moral, Doucet &
Jasra 2006; adaptive ladder per Jasra et al. 2011).  Particles start as
prior draws at beta = 0 and anneal through
p_beta propto p0(x) exp(beta loglik(x)); each stage

  1. picks the next beta by a fixed-count bisection so the conditional
     ESS of the incremental weights exp(dbeta ll_i) hits target_ess N,
  2. adds log mean_i exp(dbeta ll_i) to log Z (equal weights: every
     stage resamples),
  3. resamples systematically (one uniform, cumsum and searchsorted),
  4. rejuvenates with `num_moves` exact MALA steps targeting p_beta, at
     lr = c Var_pop (the pooled particle variance), log c adapted between
     stages by Robbins-Monro toward `target_accept`.

The stage loop is a Python loop bounded by `max_stages` with one host read
a stage (whether beta has reached 1); the bisection, the log Z sum, the
resampling and the step adaptation stay on the device.  Every MALA move
is one value-and-gradient over the whole population (the batch-potential
contract).  Random draws are batch-shaped from one generator, where the
JAX package keys each particle's draws by its global index.

The population may be one process's block of a mesh axis
(`parallel.smc_sharded` across a fleet, the counterpart of the JAX
package's `axis_name`): a `gather` hook then concatenates every block's
log likelihoods, acceptances and (to resample) particles, so that every
process takes the same stage decisions on the whole population, and
every process draws the whole population's noise from an identically
seeded generator and keeps its own rows.  A sharded
run equals the unsharded one bit for bit for row-independent potentials,
and the unsharded stream is unchanged.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..utils.pytree import (tree_leaves, tree_map, tree_random_normal,
                            tree_sum_squares_per_chain)
from .base import batch_value_and_grad
from .langevin import _where_per_chain

__all__ = ["SMCResult", "smc", "systematic_resample"]


class SMCResult(NamedTuple):
    particles: Any            # (N, ...) final particles ~ posterior
    log_z: torch.Tensor       # SMC log-evidence estimate
    num_stages: int           # stages actually used (<= max_stages)
    betas: torch.Tensor       # (max_stages,) ladder visited; NaN past the end
    ess: torch.Tensor         # (max_stages,) conditional ESS at each stage
    accept_rate: torch.Tensor  # (max_stages,) mean MALA acceptance a stage
    step_sizes: torch.Tensor  # (max_stages,) rejuvenation step size used
    log_lik: torch.Tensor     # (N,) final per-particle log likelihood


def _resample_indices(generator: torch.Generator,
                      log_weights: torch.Tensor) -> torch.Tensor:
    """Systematic (stratified single-uniform) resampling indices of the
    population; `log_weights` (N,) need not be normalized."""
    n = log_weights.shape[0]
    w = torch.softmax(log_weights, dim=0)
    cdf = torch.cumsum(w, dim=0)
    u0 = torch.rand((), generator=generator, dtype=w.dtype, device=w.device)
    u = (u0 + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    # guard the top edge against cumsum rounding (cdf[-1] may be < 1)
    return torch.clamp(torch.searchsorted(cdf, u), max=n - 1)


def systematic_resample(generator: torch.Generator,
                        log_weights: torch.Tensor, position):
    """Systematic resampling of a particle batch: every leaf's leading
    axis gathered by the same indices."""
    idx = _resample_indices(generator, log_weights)
    return tree_map(lambda l: l[idx], position)


def _pooled_variance(position) -> torch.Tensor:
    """Population variance pooled over every dimension of every leaf
    (particles on axis 0): the scale of the MALA step."""
    leaves = tree_leaves(position)
    tot = sum(l.var(dim=0, correction=0).sum() for l in leaves)
    dims = sum(math.prod(l.shape[1:]) for l in leaves)
    return tot / dims


def _conditional_ess(dbeta, ll):
    """ESS of the incremental weights exp(dbeta ll) of equal-weight
    particles, (sum w)^2 / sum w^2, in log space."""
    lw = dbeta * ll
    return torch.exp(2.0 * torch.logsumexp(lw, dim=0)
                     - torch.logsumexp(2.0 * lw, dim=0))


def _next_beta(beta, ll, target, bisect_iters: int = 40):
    """The largest dbeta in (0, 1 - beta] with cESS(dbeta) >= target, by
    bisection (cESS does not increase with dbeta), on the device."""
    hi0 = 1.0 - beta
    lo, hi = torch.zeros_like(hi0), hi0
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        ok = _conditional_ess(mid, ll) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    full = _conditional_ess(hi0, ll) >= target
    dbeta = torch.where(full, hi0, lo)
    # never stall: if even a tiny dbeta misses the target (degenerate
    # weights), still advance by the bisection floor
    return beta + torch.maximum(dbeta, hi0 * 2.0 ** (-bisect_iters))


def smc(generator: torch.Generator, log_lik_batch: Callable,
        log_prior_batch: Callable, prior_particles, *,
        num_moves: int = 5, target_ess: float = 0.5,
        step_scale: float = 0.5, target_accept: float = 0.57,
        adapt_rate: float = 1.0, max_stages: int = 100,
        gather: Optional[Callable] = None) -> SMCResult:
    """Sample p(x) propto p0(x) exp(loglik(x)) and estimate
    log Z = log int p0(x) exp(loglik(x)) dx by adaptive tempered SMC.

    `log_lik_batch` / `log_prior_batch` follow the batch-potential
    contract (leaves with a leading particle axis N -> (N,) values).
    `prior_particles` must be iid draws from the prior p0 (the beta = 0
    population).  The MALA step is lr = step_scale * the pooled particle
    variance, with log(step_scale) moved by adapt_rate (accept -
    target_accept) between stages.

    `gather`: set by `parallel.smc_sharded` when `prior_particles` is one
    process's block of a mesh axis: `gather(t)` concatenates every
    block's `t` along the leading axis in mesh order and `gather.index`
    is this block's position among them (blocks of equal size).  The
    result then holds this block's particles and log likelihoods, and the
    population-wide numbers of the whole population."""
    if not 0.0 < target_ess < 1.0:
        raise ValueError("target_ess must be in (0, 1)")
    leaves = tree_leaves(prior_particles)
    if not leaves or leaves[0].dim() < 1:
        raise ValueError("prior_particles must carry a leading particle axis")
    with torch.no_grad():
        ll0 = log_lik_batch(prior_particles)
    n_local = ll0.shape[0]
    if gather is None:
        rows, gather = slice(None), (lambda t: t)
    else:
        rows = slice(gather.index * n_local, (gather.index + 1) * n_local)
    n = gather(ll0).shape[0]                    # the whole population
    dtype, dev = ll0.dtype, ll0.device
    target = torch.tensor(target_ess * n, dtype=dtype, device=dev)

    def draw_normal(position):
        """The whole population's noise; this block's rows of it."""
        if n == n_local:
            return tree_random_normal(generator, position)
        whole = tree_map(lambda l: l.new_empty((n,) + l.shape[1:]),
                         position)
        return tree_map(lambda l: l[rows],
                        tree_random_normal(generator, whole))

    def mala_sweep(beta, lr, position):
        """num_moves exact MALA steps targeting p_beta: the moved
        particles, their loglik and the mean acceptance."""
        vag = batch_value_and_grad(
            lambda x: -(beta * log_lik_batch(x) + log_prior_batch(x)))
        u, g = vag(position)
        noise_scale = torch.sqrt(2.0 * lr)
        accs = []
        for _ in range(num_moves):
            noise = draw_normal(position)
            prop = tree_map(lambda p, gr, nz: p - lr * gr - noise_scale * nz,
                            position, g, noise)
            u_new, g_new = vag(prop)
            log_alpha = u - u_new
            rev = tree_map(lambda po, pn, gn: po - pn + lr * gn,
                           position, prop, g_new)
            fwd = tree_map(lambda pn, po, go: pn - po + lr * go,
                           prop, position, g)
            log_alpha = log_alpha + -1.0 / (4 * lr) \
                * tree_sum_squares_per_chain(rev)
            log_alpha = log_alpha - -1.0 / (4 * lr) \
                * tree_sum_squares_per_chain(fwd)
            uniform = torch.rand((n,), generator=generator, dtype=dtype,
                                 device=dev)[rows]
            accept = torch.isfinite(log_alpha) & (torch.log(uniform)
                                                  < log_alpha)
            position = _where_per_chain(accept, prop, position)
            u = torch.where(accept, u_new, u)
            g = _where_per_chain(accept, g_new, g)
            accs.append(gather(accept.to(dtype)).mean())
        with torch.no_grad():
            ll = log_lik_batch(position)
        return position, ll, torch.stack(accs).mean()

    def nan_buf():
        return torch.full((max_stages,), float("nan"), dtype=dtype,
                          device=dev)

    betas, ess, accept, steps = nan_buf(), nan_buf(), nan_buf(), nan_buf()
    position, ll = prior_particles, ll0
    beta = torch.zeros((), dtype=dtype, device=dev)
    log_z = torch.zeros((), dtype=dtype, device=dev)
    log_step = torch.log(torch.tensor(step_scale, dtype=dtype, device=dev))
    stage = 0
    while stage < max_stages and bool(beta < 1.0):
        with torch.no_grad():
            ll_all = gather(ll)
            beta_new = _next_beta(beta, ll_all, target)
            dbeta = beta_new - beta
            lw = dbeta * ll_all
            log_z = log_z + torch.logsumexp(lw, dim=0) - math.log(n)
            ess_now = _conditional_ess(dbeta, ll_all)
            idx = _resample_indices(generator, lw)
            # resample the whole population; the block keeps its rows
            position = tree_map(lambda l: gather(l)[idx], position)
            lr = torch.exp(log_step) * _pooled_variance(position)
            position = tree_map(lambda l: l[rows], position)
        position, ll, acc = mala_sweep(beta_new, lr, position)
        log_step = log_step + adapt_rate * (acc - target_accept)
        betas[stage], ess[stage] = beta_new, ess_now
        accept[stage], steps[stage] = acc, lr
        beta = beta_new
        stage += 1
    return SMCResult(particles=position, log_z=log_z, num_stages=stage,
                     betas=betas, ess=ess, accept_rate=accept,
                     step_sizes=steps, log_lik=ll)
