"""Hamiltonian samplers: exact HMC and its Stan-style warmup-adaptive
variant, and the stochastic-gradient HMC family (adaptive SGHMC, its
cyclical variant, preconditioned BAOAB and SGRHMC).

Counterpart of `bayesian_ode_tpu/samplers/hamiltonian.py`.  Every
update is elementwise or per chain, so the `*_batched` kernels over the
batch-potential contract (`sgld_batched`'s) are exactly the per-chain
kernels with the chains stacked on a leading axis; the per-chain kernels
(`hmc`, `adaptive_hmc`, `asghmc`, ...) are the batched ones over a
one-chain batch.  The step counter is a host integer: the burn-in, the
noise phase and the warmup's phases are chosen on the host, and the
noise is drawn once a step (the JAX package computes both burn-in
branches and selects).  The SG-HMC family's `info["potential"]` is the
potential before the step, as in the JAX package.

Exact HMC draws its momenta with `tree_random_normal`, its step-size
jitter and its Metropolis uniform with `torch.rand`, in that order.  The
warmup's dual-averaging state is float32 whatever the position's dtype,
as in the JAX package (`_adaptive_init`), and every step size is cast
into the leaf's dtype where it meets a leaf (`_bcast_step`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.pytree import (
    tree_map,
    tree_random_normal,
    tree_sum_squares_per_chain,
)
from . import schedules
from .base import TransitionKernel, batch_value_and_grad
from .langevin import _one_chain, _where_per_chain


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


class HMCState(NamedTuple):
    position: Any
    potential: torch.Tensor    # (C,)
    grad: Any
    step: int


def _bcast_step(eps, leaf):
    """A scalar or per-chain (C,) step broadcast over a leaf's axes, in
    the leaf's dtype (a float32 position under a float64 step stays
    float32).  A Python scalar comes back as the Python value of its
    rounding to the leaf's dtype."""
    if not torch.is_tensor(eps):
        return float(torch.tensor(eps, dtype=leaf.dtype))
    eps = eps.to(device=leaf.device, dtype=leaf.dtype)
    if eps.dim() == 0:
        return eps
    return eps.reshape(eps.shape + (1,) * (leaf.dim() - eps.dim()))


def _hmc_proposal(vag, q0, u0, g0, generator, eps0, jitter, G,
                  num_leapfrog):
    """One jittered-leapfrog HMC proposal from (q0, u0, g0), for every
    chain of the batch: `num_leapfrog` calls of `vag`, the batch
    value-and-grad.

    Returns (q, u, g, log_alpha) with log_alpha = H0 - H1, H = U + p^T G
    p / 2 and p ~ N(0, G^-1).  `eps0` is a scalar or per chain (C,); with
    `jitter` j each chain draws eps ~ U[1 - j, 1 + j] eps0."""
    noise = tree_random_normal(generator, q0)
    if jitter:
        u = torch.rand(u0.shape, generator=generator, dtype=u0.dtype,
                       device=u0.device)
        eps = eps0 * (1.0 + jitter * (2.0 * u - 1.0))
    else:
        eps = eps0

    def e(leaf):
        return _bcast_step(eps, leaf)

    p0 = tree_map(lambda n, G_: n / torch.sqrt(G_), noise, G)
    kin0 = 0.5 * tree_sum_squares_per_chain(tree_map(
        lambda p, G_: torch.sqrt(G_) * p, p0, G))

    # leapfrog: half kick, (L - 1) x (drift + kick), drift, half kick
    p = tree_map(lambda p_, g_: p_ - 0.5 * e(p_) * g_, p0, g0)
    q = tree_map(lambda q_, G_, p_: q_ + e(q_) * G_ * p_, q0, G, p)
    u, g = vag(q)
    for _ in range(num_leapfrog - 1):
        p = tree_map(lambda p_, g_: p_ - e(p_) * g_, p, g)
        q = tree_map(lambda q_, G_, p_: q_ + e(q_) * G_ * p_, q, G, p)
        u, g = vag(q)
    p = tree_map(lambda p_, g_: p_ - 0.5 * e(p_) * g_, p, g)

    kin1 = 0.5 * tree_sum_squares_per_chain(tree_map(
        lambda p_, G_: torch.sqrt(G_) * p_, p, G))
    return q, u, g, (u0 + kin0) - (u + kin1)


def _metropolis(generator, log_alpha):
    """The per-chain accept mask: isfinite(log_alpha) & log u < log_alpha."""
    uniform = torch.rand(log_alpha.shape, generator=generator,
                         dtype=log_alpha.dtype, device=log_alpha.device)
    return torch.isfinite(log_alpha) & (torch.log(uniform) < log_alpha)


def _make_hmc(potential_batch, step_size, num_leapfrog, precond, jitter):
    """Exact Hamiltonian Monte Carlo (Neal 2011): a full momentum refresh
    each step, `num_leapfrog` leapfrog steps (the initial gradient cached
    in the state) and a Metropolis correction on the Hamiltonian error,
    so no step-size bias at any (eps, L).

    `precond`: an optional FIXED diagonal inverse-mass G (a tree
    matching the position, leaves broadcastable): p ~ N(0, G^-1),
    kinetic energy p^T G p / 2, drift q += eps G p.  `jitter` j draws
    eps ~ U[(1 - j) eps0, (1 + j) eps0] per chain and proposal, against
    periodic-orbit resonance; the step is symmetric within a proposal,
    so exactness is kept."""
    sched = schedules.resolve(step_size)
    vag = batch_value_and_grad(potential_batch)

    def init(position):
        u, g = vag(position)
        return HMCState(position, u, g, 0)

    def step(generator, state):
        eps0 = sched(state.step)
        G = precond if precond is not None else tree_map(
            torch.ones_like, state.position)
        q, u, g, log_alpha = _hmc_proposal(
            vag, state.position, state.potential, state.grad, generator,
            eps0, jitter, G, num_leapfrog)
        accept = _metropolis(generator, log_alpha)
        new_state = HMCState(
            position=_where_per_chain(accept, q, state.position),
            potential=torch.where(accept, u, state.potential),
            grad=_where_per_chain(accept, g, state.grad),
            step=state.step + 1)
        info = {"potential": new_state.potential, "accepted": accept,
                "step_size": eps0}
        return new_state, info

    return TransitionKernel(init, step)


def hmc_batched(potential_batch: Callable, step_size,
                num_leapfrog: int = 10, precond: Optional[Any] = None,
                jitter: float = 0.0) -> TransitionKernel:
    """Exact HMC over the batch-potential contract (`sgld_batched`):
    `num_leapfrog` forward and backward passes of the whole batch a
    proposal; per-chain momenta, Hamiltonian errors, jittered step sizes
    and accept masks.  See `_make_hmc`."""
    return _make_hmc(potential_batch, step_size, num_leapfrog, precond,
                     jitter)


def hmc(potential_fn: Callable, step_size, num_leapfrog: int = 10,
        precond: Optional[Any] = None, jitter: float = 0.0
        ) -> TransitionKernel:
    """Exact HMC of one chain: `hmc_batched` over a one-chain batch."""
    return _one_chain(hmc_batched, potential_fn, step_size,
                      num_leapfrog=num_leapfrog, precond=precond,
                      jitter=jitter)


class AdaptiveHMCState(NamedTuple):
    position: Any
    potential: torch.Tensor    # (C,)
    grad: Any
    step: int
    log_eps: torch.Tensor      # (C,) float32: the dual-averaging iterate
    log_eps_avg: torch.Tensor  # (C,) float32: its average (the frozen value)
    h_avg: torch.Tensor        # (C,) float32: running (target - accept)
    mu: torch.Tensor           # (C,) float32: the shrinkage anchor
    mean: Any                  # Welford position mean (phase 1)
    m2: Any                    # Welford sum of squared deviations
    mass_g: Any                # the diagonal inverse mass G


# Stan's dual-averaging constants
GAMMA, T0, KAPPA = 0.05, 10.0, 0.75
F32 = torch.float32


def _step_of(log_eps):
    """exp of a float32 log step size (one function, so that a test can
    hold the port's float32 rounding to another library's)."""
    return torch.exp(log_eps)


def _adaptive_init(vag, eps0, init_mass=None):
    """The initial AdaptiveHMCState shared by adaptive HMC and NUTS.

    `init_mass`: an optional diagonal inverse mass (a tree broadcastable
    against the position) for warmup phase 1 instead of the identity.  On
    stiff posteriors (the GP-ODE one) identity-mass leapfrogs diverge or
    drive NUTS to max-depth trees; seeding with the pSGLD warm-up metric
    (`psgld_preconditioner`) makes phase 1 productive.  The A/2 switch
    still replaces it with the measured variance when `adapt_mass` is on
    (Stan's init-metric semantics)."""
    def init(position):
        u, g = vag(position)
        log_eps = torch.full(u.shape, math.log(eps0), dtype=F32,
                             device=u.device)
        if init_mass is None:
            mass_g = tree_map(torch.ones_like, position)
        else:
            mass_g = tree_map(
                lambda m, x: torch.as_tensor(m, dtype=x.dtype,
                                             device=x.device)
                .expand(x.shape).clone(), init_mass, position)
        return AdaptiveHMCState(
            position=position, potential=u, grad=g, step=0,
            log_eps=log_eps, log_eps_avg=log_eps.clone(),
            h_avg=torch.zeros_like(log_eps), mu=log_eps + math.log(10.0),
            mean=tree_map(torch.zeros_like, position),
            m2=tree_map(torch.zeros_like, position), mass_g=mass_g)

    return init


def _f32(x) -> float:
    """The Python value of x rounded to float32."""
    return float(np.float32(x))


def _warmup_advance(state, position, a_prob, num_adapt, target_accept,
                    adapt_mass):
    """One step of the two-phase warmup shared by `adaptive_hmc` and
    `nuts.adaptive_nuts`: the dual-averaging update of the log step size
    driven by this transition's accept statistic `a_prob` ((C,) in
    [0, 1]: the MH accept probability for HMC, the trajectory's mean
    alpha for NUTS; the caller maps non-finite proposals to 0), the
    Welford position variance over phase 1, and the A/2 switch (freeze
    the diagonal inverse mass at the regularized variance, restart dual
    averaging around the averaged step).  Returns the new (log_eps,
    log_eps_avg, h_avg, mu, mean, m2, mass_g).

    The step counter is a host integer, so the phase, the restart index
    t and the switch are chosen here; t's functions are float32 host
    scalars, as the JAX package's float32 scalars."""
    half = num_adapt // 2
    step = state.step
    log_eps, log_eps_avg, h_avg = state.log_eps, state.log_eps_avg, \
        state.h_avg
    if step < num_adapt:
        # dual averaging on target - accept_prob (t restarts at A/2)
        t = np.float32((step if step < half else step - half) + 1.0)
        tt0 = np.float32(t + np.float32(T0))
        a_prob = a_prob.to(F32)
        h_avg = (_f32(np.float32(1.0) - np.float32(1.0) / tt0) * h_avg
                 + (target_accept - a_prob) / float(tt0))
        log_eps = state.mu - _f32(np.sqrt(t) / np.float32(GAMMA)) * h_avg
        eta = np.float32(t ** np.float32(-KAPPA))
        log_eps_avg = (float(eta) * log_eps
                       + _f32(np.float32(1.0) - eta) * state.log_eps_avg)

    mean, m2 = state.mean, state.m2
    if step < half:
        # Welford over the phase-1 positions
        n = float(step + 1)
        mean = tree_map(lambda m, x: m + (x - m) / n, state.mean, position)
        m2 = tree_map(lambda s, m_old, m_new, x: s + (x - m_old) * (x - m_new),
                      state.m2, state.mean, mean, position)

    mass_g, mu = state.mass_g, state.mu
    if step + 1 == half:
        # the A/2 switch: freeze the mass, restart dual averaging
        if adapt_mass and half > 1:
            cnt = np.float32(half)
            shrink = _f32(cnt / (cnt + np.float32(5.0)))
            floor = _f32(np.float32(1e-3)
                         * (np.float32(5.0) / (cnt + np.float32(5.0))))
            mass_g = tree_map(lambda s: shrink * (s / float(cnt - 1.0))
                              + floor, m2)
        mu = log_eps_avg + math.log(10.0)
        h_avg = torch.zeros_like(h_avg)
        log_eps = log_eps_avg
    return log_eps, log_eps_avg, h_avg, mu, mean, m2, mass_g


def _make_adaptive_hmc(potential_batch, eps0, num_adapt, target_accept,
                       num_leapfrog, jitter, adapt_mass, init_mass=None):
    """HMC with Stan-style warmup: a dual-averaging step size (Hoffman &
    Gelman 2014, section 3.2) and a Welford diagonal inverse mass, both
    FROZEN after `num_adapt` steps, so the chain after warmup is exactly
    reversible; draws taken before step `num_adapt` are warmup (set
    burn_in >= num_adapt).

    Over the warmup window A = num_adapt: steps [0, A/2) adapt eps under
    the initial mass while accumulating each chain's position variance;
    at A/2 G freezes at the regularized variance (Stan's n/(n + 5)
    shrinkage toward 1e-3) and dual averaging restarts around the
    current eps; steps [A/2, A) adapt eps under the final mass; at A, eps
    freezes at exp(log_eps_avg).  Each chain adapts its own (eps, G)."""
    vag = batch_value_and_grad(potential_batch)
    init = _adaptive_init(vag, eps0, init_mass)

    def step(generator, state):
        eps = _step_of(state.log_eps if state.step < num_adapt
                       else state.log_eps_avg)
        q, u, g, log_alpha = _hmc_proposal(
            vag, state.position, state.potential, state.grad, generator,
            eps, jitter, state.mass_g, num_leapfrog)
        accept = _metropolis(generator, log_alpha)
        position = _where_per_chain(accept, q, state.position)
        potential = torch.where(accept, u, state.potential)
        grad = _where_per_chain(accept, g, state.grad)

        finite = torch.isfinite(log_alpha)
        a_prob = torch.where(
            finite, torch.exp(torch.clamp(log_alpha, max=0.0)),
            torch.zeros_like(log_alpha))
        (log_eps, log_eps_avg, h_avg, mu, mean, m2, mass_g) = \
            _warmup_advance(state, position, a_prob, num_adapt,
                            target_accept, adapt_mass)
        new_state = AdaptiveHMCState(
            position=position, potential=potential, grad=grad,
            step=state.step + 1, log_eps=log_eps, log_eps_avg=log_eps_avg,
            h_avg=h_avg, mu=mu, mean=mean, m2=m2, mass_g=mass_g)
        info = {"potential": potential, "accepted": accept,
                "step_size": _step_of(log_eps_avg)}
        return new_state, info

    return TransitionKernel(init, step)


def adaptive_hmc_batched(potential_batch: Callable, num_adapt: int,
                         step_size: float = 0.1, target_accept: float = 0.8,
                         num_leapfrog: int = 10, jitter: float = 0.2,
                         adapt_mass: bool = True,
                         init_mass: Optional[Any] = None
                         ) -> TransitionKernel:
    """Warmup-adaptive exact HMC over the batch-potential contract: every
    chain adapts its own step size and diagonal inverse mass from its own
    warmup history.  `init_mass` seeds the warmup metric (on the stiff GP
    posterior pass `psgld_preconditioner` of a pSGLD warm-up state).  See
    `_make_adaptive_hmc`."""
    return _make_adaptive_hmc(potential_batch, step_size, num_adapt,
                              target_accept, num_leapfrog, jitter,
                              adapt_mass, init_mass=init_mass)


def adaptive_hmc(potential_fn: Callable, num_adapt: int,
                 step_size: float = 0.1, target_accept: float = 0.8,
                 num_leapfrog: int = 10, jitter: float = 0.2,
                 adapt_mass: bool = True,
                 init_mass: Optional[Any] = None) -> TransitionKernel:
    """Warmup-adaptive exact HMC of one chain."""
    return _one_chain(adaptive_hmc_batched, potential_fn, num_adapt,
                      step_size=step_size, target_accept=target_accept,
                      num_leapfrog=num_leapfrog, jitter=jitter,
                      adapt_mass=adapt_mass, init_mass=init_mass)
