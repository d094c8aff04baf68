"""The stochastic-gradient HMC family: adaptive SGHMC, its cyclical
variant, preconditioned BAOAB and SGRHMC.

Counterpart of the SG-HMC part of `bayesian_ode_tpu/samplers/hamiltonian.py`
(HMC, NUTS and the other exact samplers there are ROADMAP queue 1 item
14).  Every update is elementwise, so the `*_batched` kernels over the
batch-potential contract (`sgld_batched`'s) are exactly the per-chain
kernels with the chains stacked on a leading axis; the per-chain kernels
(`asghmc`, `acsghmc`, `baoab`, `sgrhmc`) are the batched ones over a
one-chain batch.  The step counter is a host integer: the burn-in and the
noise phase are chosen on the host, and the noise is drawn once a step
(the JAX package computes both burn-in branches and selects).
`info["potential"]` is the potential before the step, as in the JAX
package.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..utils.pytree import tree_map, tree_random_normal
from . import schedules
from .base import TransitionKernel, batch_value_and_grad
from .langevin import _one_chain


class SGHMCState(NamedTuple):
    position: Any
    potential: torch.Tensor
    grad: Any
    tau: Any           # moving-average window sizes
    g: Any             # averaged gradient
    v_hat: Any         # gradient variance estimate
    momentum: Any
    step: int


def _make_sghmc(potential_batch, lr_fn, mom_decay, lambda_, resample_every,
                burn_in_steps, noise_fn) -> TransitionKernel:
    """Adaptive SGHMC (reference hamiltonian.py:55-102).  During burn-in
    (tau, g, v_hat) adapt; Minv = 1/(sqrt(v_hat) + lambda);
        m <- m - lr^2 Minv grad - c m + N(0, max(2 lr^2 c Minv - lr^4, 1e-16))
    then theta += m.  Outside burn-in the momentum is optionally resampled
    every `resample_every` steps with std min(1/Minv, 10)."""
    vag = batch_value_and_grad(potential_batch)

    def init(position):
        u, g = vag(position)
        ones = tree_map(torch.ones_like, position)
        return SGHMCState(position, u, g, ones, ones, ones,
                          tree_map(torch.zeros_like, position), 0)

    def step(generator, state):
        lr = lr_fn(state.step)
        grad = state.grad
        if state.step < burn_in_steps:
            tau_inv = tree_map(lambda t: 1.0 / (t + 1.0), state.tau)
            tau = tree_map(
                lambda t, ga, vh: t - t * (ga * ga / (vh + lambda_)) + 1.0,
                state.tau, state.g, state.v_hat)
            g_avg = tree_map(lambda ga, ti, gr: ga - ga * ti + ti * gr,
                             state.g, tau_inv, grad)
            v_hat = tree_map(lambda vh, ti, gr: vh - vh * ti + ti * gr ** 2,
                             state.v_hat, tau_inv, grad)
            resample = False
        else:
            tau, g_avg, v_hat = state.tau, state.g, state.v_hat
            resample = (resample_every is not None
                        and state.step % resample_every == 0)
        minv = tree_map(lambda vh: 1.0 / (torch.sqrt(vh) + lambda_), v_hat)

        momentum = state.momentum
        if resample:
            momentum = tree_map(
                lambda mi, n: torch.clamp(1.0 / mi, max=1e1) * n,
                minv, tree_random_normal(generator, momentum))
        momentum = tree_map(
            lambda m, mi, gr: m - lr ** 2 * mi * gr - mom_decay * m,
            momentum, minv, grad)
        if noise_fn(state.step):
            sigma = tree_map(lambda mi: torch.sqrt(torch.clamp(
                2.0 * lr ** 2 * mom_decay * mi - lr ** 4, min=1e-16)), minv)
            momentum = tree_map(lambda m, s, n: m + s * n, momentum, sigma,
                                tree_random_normal(generator, momentum))
        position = tree_map(lambda p, m: p + m, state.position, momentum)
        u, g = vag(position)
        info = {"potential": state.potential, "accepted": True,
                "step_size": lr}
        return SGHMCState(position, u, g, tau, g_avg, v_hat, momentum,
                          state.step + 1), info

    return TransitionKernel(init, step)


def asghmc_batched(potential_batch: Callable, step_size, burn_in_steps: int,
                   mom_decay: float = 5e-2, lambda_: float = 1e-5,
                   resample_momentum_every: Optional[int] = None,
                   add_noise: bool = True) -> TransitionKernel:
    """Adaptive SGHMC (reference hamiltonian.py:11-164) over a whole chain
    batch per step: (tau, g, v_hat) adapt for the first `burn_in_steps`
    steps.  `add_noise=False` exists for deterministic equivalence tests."""
    return _make_sghmc(potential_batch, schedules.resolve(step_size),
                       mom_decay, lambda_, resample_momentum_every,
                       burn_in_steps, lambda t: add_noise)


def acsghmc_batched(potential_batch: Callable, lr0: float, num_cycles: int,
                    total_iters: int, burn_in_steps: int, beta: float = 0.25,
                    mom_decay: float = 5e-2, lambda_: float = 1e-5,
                    resample_momentum_every: Optional[int] = None
                    ) -> TransitionKernel:
    """Cyclical adaptive SGHMC (reference hamiltonian.py:167-334) over a
    whole chain batch: cosine step size, noise only in the sampling phase
    of each cycle (r > beta)."""
    return _make_sghmc(
        potential_batch, schedules.cyclical_cosine(lr0, num_cycles,
                                                   total_iters),
        mom_decay, lambda_, resample_momentum_every, burn_in_steps,
        lambda t: schedules.cycle_position(t, num_cycles, total_iters) > beta)


def asghmc(potential_fn: Callable, step_size, burn_in_steps: int,
           mom_decay: float = 5e-2, lambda_: float = 1e-5,
           resample_momentum_every: Optional[int] = None,
           add_noise: bool = True) -> TransitionKernel:
    """Adaptive SGHMC of one chain."""
    return _one_chain(asghmc_batched, potential_fn, step_size, burn_in_steps,
                      mom_decay=mom_decay, lambda_=lambda_,
                      resample_momentum_every=resample_momentum_every,
                      add_noise=add_noise)


def acsghmc(potential_fn: Callable, lr0: float, num_cycles: int,
            total_iters: int, burn_in_steps: int, beta: float = 0.25,
            mom_decay: float = 5e-2, lambda_: float = 1e-5,
            resample_momentum_every: Optional[int] = None) -> TransitionKernel:
    """Cyclical adaptive SGHMC of one chain."""
    return _one_chain(acsghmc_batched, potential_fn, lr0, num_cycles,
                      total_iters, burn_in_steps, beta=beta,
                      mom_decay=mom_decay, lambda_=lambda_,
                      resample_momentum_every=resample_momentum_every)


class BAOABState(NamedTuple):
    position: Any
    potential: torch.Tensor
    grad: Any
    v_hat: Any         # EMA of squared gradients (frozen after burn-in)
    momentum: Any
    step: int


def baoab_batched(potential_batch: Callable, step_size,
                  friction: float = 1.0, lambda_: float = 1e-5,
                  burn_in_steps: int = 0, beta_ema: float = 0.99
                  ) -> TransitionKernel:
    """Preconditioned BAOAB splitting for underdamped Langevin over a whole
    chain batch per step (one gradient a step, the trailing B reused as the
    next step's leading B).  Mass 1/G with G = 1/(sqrt(v_hat) + lambda);
    v_hat adapts by EMA during burn-in and is frozen after it:

        B: p <- p - h/2 grad
        A: theta <- theta + h/2 G p
        O: p <- c1 p + sqrt(1 - c1^2) / sqrt(G) xi,  c1 = exp(-friction h)
        A: theta <- theta + h/2 G p
        B: p <- p - h/2 grad(theta_new)

    The JAX package's measured caveat holds: on the Van der Pol GP
    posterior it was more biased than aSGHMC at these step sizes."""
    lr_fn = schedules.resolve(step_size)
    vag = batch_value_and_grad(potential_batch)

    def init(position):
        u, g = vag(position)
        return BAOABState(position, u, g, tree_map(torch.zeros_like, g),
                          tree_map(torch.zeros_like, position), 0)

    def step(generator, state):
        h = lr_fn(state.step)
        if state.step < burn_in_steps:
            v_hat = tree_map(
                lambda v, g: beta_ema * v + (1 - beta_ema) * g ** 2,
                state.v_hat, state.grad)
        else:
            v_hat = state.v_hat
        G = tree_map(lambda v: 1.0 / (torch.sqrt(v) + lambda_), v_hat)
        p1 = tree_map(lambda p, g: p - 0.5 * h * g, state.momentum,
                      state.grad)
        th_half = tree_map(lambda t, G_, p: t + 0.5 * h * G_ * p,
                           state.position, G, p1)
        c1 = math.exp(-friction * h)
        c2 = math.sqrt(max(1.0 - c1 * c1, 0.0))
        p2 = tree_map(lambda p, G_, n: c1 * p + c2 * n / torch.sqrt(G_), p1, G,
                      tree_random_normal(generator, state.momentum))
        th_new = tree_map(lambda t, G_, p: t + 0.5 * h * G_ * p, th_half, G,
                          p2)
        u, g_new = vag(th_new)
        p_new = tree_map(lambda p, g: p - 0.5 * h * g, p2, g_new)
        info = {"potential": state.potential, "accepted": True,
                "step_size": h}
        return BAOABState(th_new, u, g_new, v_hat, p_new,
                          state.step + 1), info

    return TransitionKernel(init, step)


def baoab(potential_fn: Callable, step_size, friction: float = 1.0,
          lambda_: float = 1e-5, burn_in_steps: int = 0,
          beta_ema: float = 0.99) -> TransitionKernel:
    """Preconditioned BAOAB of one chain."""
    return _one_chain(baoab_batched, potential_fn, step_size,
                      friction=friction, lambda_=lambda_,
                      burn_in_steps=burn_in_steps, beta_ema=beta_ema)


class SGRHMCState(NamedTuple):
    position: Any
    potential: torch.Tensor
    grad: Any
    v: Any             # EMA of squared gradients (metric)
    momentum: Any
    step: int


def sgrhmc_batched(potential_batch: Callable, step_size,
                   friction: float = 0.1, beta: float = 0.99,
                   lambda_: float = 1e-5) -> TransitionKernel:
    """Stochastic Gradient Riemannian HMC (Ma, Chen & Fox 2015, the
    reference's stub completed) with the diagonal RMSprop metric
    G = diag(1/(lambda + sqrt(V))), over a whole chain batch per step:

        V <- beta V + (1 - beta) g^2
        r <- r - eps G^{1/2} g - eps C r + N(0, 2 eps C)
        theta <- theta + eps G^{1/2} r

    (the metric-derivative term dropped, as pSGLD drops it)."""
    sched = schedules.resolve(step_size)
    vag = batch_value_and_grad(potential_batch)

    def init(position):
        u, g = vag(position)
        return SGRHMCState(position, u, g, tree_map(torch.zeros_like, g),
                           tree_map(torch.zeros_like, position), 0)

    def step(generator, state):
        eps = sched(state.step)
        v = tree_map(lambda v_, g_: beta * v_ + (1 - beta) * g_ ** 2,
                     state.v, state.grad)
        ghalf = tree_map(lambda v_: 1.0 / torch.sqrt(torch.sqrt(v_) + lambda_),
                         v)
        noise = tree_random_normal(generator, state.momentum)
        sigma = math.sqrt(2.0 * eps * friction)
        r = tree_map(lambda r_, gh, g_, n: r_ - eps * gh * g_
                     - eps * friction * r_ + sigma * n,
                     state.momentum, ghalf, state.grad, noise)
        position = tree_map(lambda p, gh, r_: p + eps * gh * r_,
                            state.position, ghalf, r)
        u, g = vag(position)
        info = {"potential": state.potential, "accepted": True,
                "step_size": eps}
        return SGRHMCState(position, u, g, v, r, state.step + 1), info

    return TransitionKernel(init, step)


def sgrhmc(potential_fn: Callable, step_size, friction: float = 0.1,
           beta: float = 0.99, lambda_: float = 1e-5) -> TransitionKernel:
    """SGRHMC of one chain."""
    return _one_chain(sgrhmc_batched, potential_fn, step_size,
                      friction=friction, beta=beta, lambda_=lambda_)
