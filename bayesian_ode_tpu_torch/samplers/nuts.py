"""No-U-Turn sampler (NUTS): multinomial HMC with dynamic trajectories.

Counterpart of `bayesian_ode_tpu/samplers/nuts.py`: multinomial NUTS with
biased progressive sampling (Hoffman & Gelman 2014; Betancourt 2017,
arXiv:1701.02434 section A.4).  Each transition doubles a leapfrog
trajectory in a random direction until a sub-trajectory U-turns or
diverges, and samples a point of the trajectory with weights
exp(-(H - H0)), so it is exact at any step size.

Tree building is iterative with fixed-shape state, as in the JAX package:
a loop over the tree depth, each subtree a loop of single leapfrog steps,
and the recursive sub-U-turn checks replaced by a `max_depth`-slot
checkpoint buffer of (momentum, running momentum sum) pairs indexed by the
bit pattern of the leaf counter: every balanced subtree interval [s, n]
is tested through rho[s..n] = rho[0..n] - rho[0..s] + p_s when its last
leaf n is added.  Positions and momenta are flattened to (C, D) so the
buffers and the U-turn contractions are plain tensor operations.

The JAX package's two `lax.while_loop`s are Python loops here.  Every
update is masked per chain, so a chain whose tree has stopped stays as it
is while the others build, and the batch potential is still evaluated on
the whole batch at every leapfrog (the fused kernels take the whole
batch).  Each leapfrog costs one host read (whether any chain is still
building), each doubling one more.  The per-chain kernels (`nuts`,
`adaptive_nuts`) are the batched ones over a one-chain batch.

Draws: the momenta with `torch.randn`, then per doubling the direction
(`torch.rand(C) < 0.5`), per leaf the subtree's proposal uniform and
after the subtree the top-level proposal uniform (`torch.rand`).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..utils.pytree import tree_leaves, tree_map, tree_unflatten
from . import schedules
from .base import TransitionKernel, batch_value_and_grad
from .hamiltonian import (
    AdaptiveHMCState,
    HMCState,
    _adaptive_init,
    _step_of,
    _warmup_advance,
)
from .langevin import _one_chain

__all__ = ["nuts", "nuts_batched", "adaptive_nuts", "adaptive_nuts_batched"]


def _flatteners(position):
    """(flat, unflat) closing over `position`'s structure: flat
    concatenates every leaf, less its leading chain axis, into one
    (C, D) tensor of the promoted float dtype; unflat restores the leaves'
    shapes and dtypes."""
    leaves = tree_leaves(position)
    shapes = [tuple(x.shape[1:]) for x in leaves]
    sizes = [math.prod(s) for s in shapes]
    dtype = leaves[0].dtype
    for x in leaves[1:]:
        dtype = torch.promote_types(dtype, x.dtype)

    def flat(tree):
        return torch.cat([x.reshape(x.shape[0], -1).to(dtype)
                          for x in tree_leaves(tree)], -1)

    def unflat(x):
        parts = torch.split(x, sizes, dim=-1)
        return tree_unflatten(position, [
            p.reshape(x.shape[:-1] + s).to(leaf.dtype)
            for p, s, leaf in zip(parts, shapes, leaves)])

    return flat, unflat


def _popcount(n: torch.Tensor, nbits: int) -> torch.Tensor:
    """Number of set bits of a non-negative integer tensor (unrolled)."""
    c = torch.zeros_like(n)
    for b in range(nbits):
        c = c + ((n >> b) & 1)
    return c


def _trailing_ones(n: torch.Tensor, nbits: int) -> torch.Tensor:
    """Number of contiguous low-order 1-bits (e.g. 0b0111 -> 3)."""
    t = torch.zeros_like(n)
    still = torch.ones(n.shape, dtype=torch.bool, device=n.device)
    for b in range(nbits):
        still = still & (((n >> b) & 1) == 1)
        t = t + still.to(n.dtype)
    return t


def _nuts_transition(vag_flat, generator, q0, u0, g0, eps, G, max_depth,
                     max_delta):
    """One NUTS transition of every chain on flat states.

    q0, g0, G: (C, D); u0: (C,); eps: a scalar or (C,).  Returns (q, u, g,
    info): the sampled point and the per-chain diagnostics."""
    C, D = q0.shape
    dt, dev = q0.dtype, q0.device
    ND = max(max_depth, 1)               # checkpoint slots
    nbits = max_depth + 1
    i32 = torch.int32

    def rand():
        return torch.rand((C,), generator=generator, dtype=dt, device=dev)

    p0 = torch.randn(q0.shape, generator=generator, dtype=dt,
                     device=dev) / torch.sqrt(G)
    h0 = u0 + 0.5 * torch.sum(G * p0 * p0, -1)
    eps = torch.as_tensor(eps, dtype=dt, device=dev).expand(C)

    def leapfrog(q, p, g, e_signed):
        e = e_signed[:, None]
        p_half = p - 0.5 * e * g
        q_n = q + e * G * p_half
        u_n, g_n = vag_flat(q_n)
        return q_n, p_half - 0.5 * e * g_n, g_n, u_n

    jr = torch.arange(ND, dtype=i32, device=dev)
    zeros_i = torch.zeros(C, dtype=i32, device=dev)
    false = torch.zeros(C, dtype=torch.bool, device=dev)
    zeros_f = torch.zeros(C, dtype=dt, device=dev)
    ninf = torch.full((C,), -math.inf, dtype=dt, device=dev)

    depth, done, diverging, moved = zeros_i, false, false, false
    q_l = q_r = pq = q0
    p_l = p_r = p0
    g_l = g_r = pg = g0
    pu, lw, rho = u0, zeros_f, p0
    sum_a, n_a, n_leap = zeros_f, zeros_i, zeros_i

    while True:
        active = ~done
        if not bool(active.any()):
            break
        going_right = rand() < 0.5
        e_signed = torch.where(going_right, eps, -eps)
        n_leaf = 1 << depth                                # (C,)
        gr = going_right[:, None]
        q_e = torch.where(gr, q_r, q_l)
        p_e = torch.where(gr, p_r, p_l)
        g_e = torch.where(gr, g_r, g_l)

        # the subtree: one leapfrog a leaf
        i = zeros_i
        sub_lw = ninf
        spq, spu, spg = q_e, zeros_f, g_e
        srho = torch.zeros_like(q0)
        ck_p = torch.zeros((C, ND, D), dtype=dt, device=dev)
        ck_rho = torch.zeros_like(ck_p)
        turning, s_div = false, false
        s_sum_a, s_n_a = zeros_f, zeros_i
        while True:
            act = active & (i < n_leaf) & ~turning & ~s_div
            if not bool(act.any()):
                break
            q_n, p_n, g_n, u_n = leapfrog(q_e, p_e, g_e, e_signed)
            dh = u_n + 0.5 * torch.sum(G * p_n * p_n, -1) - h0
            finite = torch.isfinite(dh)
            ok = finite & (dh <= max_delta)
            alpha = torch.where(finite, torch.exp(torch.clamp(-dh, max=0.0)),
                                zeros_f)
            s_sum_a = s_sum_a + torch.where(act, alpha, zeros_f)
            s_n_a = s_n_a + act.to(i32)

            add = act & ok                     # the leaf joins the subtree
            adde = add[:, None]
            srho = torch.where(adde, srho + p_n, srho)

            # progressive multinomial proposal within the subtree: replace
            # with probability exp(w - logsumexp(weights so far))
            w = torch.where(ok, -dh, ninf)
            new_lw = torch.logaddexp(sub_lw, w)
            ratio = torch.where(add, w - new_lw, ninf)
            take = add & (torch.log(rand()) < ratio)
            sub_lw = torch.where(add, new_lw, sub_lw)
            spq = torch.where(take[:, None], q_n, spq)
            spu = torch.where(take, u_n, spu)
            spg = torch.where(take[:, None], g_n, spg)

            # checkpoints: an even leaf i starts balanced intervals and
            # stores (p_i, rho[0..i]) at slot popcount(i >> 1); an odd leaf
            # closes the intervals whose slots are the contiguous range
            # ending at that slot, one per trailing 1-bit of i
            slot = _popcount(i >> 1, nbits)
            onehot = jr == slot[:, None]                      # (C, ND)
            store = ((add & ((i & 1) == 0))[:, None] & onehot)[..., None]
            ck_p = torch.where(store, p_n[:, None, :], ck_p)
            ck_rho = torch.where(store, srho[:, None, :], ck_rho)

            idx_min = slot - _trailing_ones(i, nbits) + 1
            inr = (jr >= idx_min[:, None]) & (jr <= slot[:, None])
            rho_int = srho[:, None, :] - ck_rho + ck_p        # (C, ND, D)
            d1 = torch.sum(G[:, None, :] * ck_p * rho_int, -1)
            d2 = torch.sum(G[:, None, :] * p_n[:, None, :] * rho_int, -1)
            turn_here = torch.any(inr & ((d1 <= 0.0) | (d2 <= 0.0)), -1)
            turning = turning | (add & ((i & 1) == 1) & turn_here)
            s_div = s_div | (act & ~ok)
            i = i + act.to(i32)
            q_e = torch.where(adde, q_n, q_e)
            p_e = torch.where(adde, p_n, p_e)
            g_e = torch.where(adde, g_n, g_e)

        # a subtree that U-turned or diverged inside is discarded whole
        # (Betancourt 2017, A.4.2): no proposal update, and the tree stops
        completed = active & ~turning & ~s_div
        take_top = completed & (torch.log(rand()) < (sub_lw - lw))
        tt = take_top[:, None]
        pq = torch.where(tt, spq, pq)
        pu = torch.where(take_top, spu, pu)
        pg = torch.where(tt, spg, pg)
        lw = torch.where(completed, torch.logaddexp(lw, sub_lw), lw)
        rho = torch.where(completed[:, None], rho + srho, rho)
        upd_r = (completed & going_right)[:, None]
        upd_l = (completed & ~going_right)[:, None]
        q_r = torch.where(upd_r, q_e, q_r)
        p_r = torch.where(upd_r, p_e, p_r)
        g_r = torch.where(upd_r, g_e, g_r)
        q_l = torch.where(upd_l, q_e, q_l)
        p_l = torch.where(upd_l, p_e, p_l)
        g_l = torch.where(upd_l, g_e, g_l)
        # Betancourt's criterion with the diagonal inverse mass: v = G p
        turn_top = ((torch.sum(G * p_l * rho, -1) <= 0.0)
                    | (torch.sum(G * p_r * rho, -1) <= 0.0))
        depth = depth + active.to(i32)
        done = done | (active & (~completed | turn_top)) | (depth >= max_depth)
        diverging = diverging | (active & s_div)
        moved = moved | take_top
        sum_a = sum_a + s_sum_a
        n_a = n_a + s_n_a
        n_leap = n_leap + i

    info = {"accept_prob": sum_a / torch.clamp(n_a, min=1).to(dt),
            "accepted": moved, "depth": depth, "n_leapfrog": n_leap,
            "diverging": diverging}
    return pq, pu, pg, info


def _flat_vag(vag, unflat, flat):
    def vag_flat(q):
        u, g = vag(unflat(q))
        return u, flat(g)
    return vag_flat


def _make_nuts(potential_batch, step_size, max_depth, precond, max_delta):
    sched = schedules.resolve(step_size)
    vag = batch_value_and_grad(potential_batch)

    def init(position):
        u, g = vag(position)
        return HMCState(position, u, g, 0)

    def step(generator, state):
        flat, unflat = _flatteners(state.position)
        q0 = flat(state.position)
        G = torch.ones_like(q0) if precond is None else flat(tree_map(
            lambda p, x: torch.as_tensor(p, dtype=x.dtype, device=x.device)
            .expand(x.shape), precond, state.position))
        eps = sched(state.step)
        q, u, g, info = _nuts_transition(
            _flat_vag(vag, unflat, flat), generator, q0, state.potential,
            flat(state.grad), eps, G, max_depth, max_delta)
        info.update(potential=u, step_size=eps)
        return HMCState(unflat(q), u, unflat(g), state.step + 1), info

    return TransitionKernel(init, step)


def nuts_batched(potential_batch: Callable, step_size, max_depth: int = 10,
                 precond: Optional[object] = None,
                 max_delta_energy: float = 1000.0) -> TransitionKernel:
    """Multinomial NUTS over the batch-potential contract (`sgld_batched`):
    every leapfrog is one forward and backward pass of the whole batch;
    each chain grows and stops its own tree by its masks, and chains whose
    trees have stopped wait for the slowest tree of the transition.
    `step_size` is a float or a schedule; `precond` an optional fixed
    diagonal inverse mass (as `hmc`'s); a trajectory stops at a U-turn, a
    divergence (energy error > `max_delta_energy`) or `max_depth`
    doublings (at most 2**max_depth - 1 leapfrogs a transition)."""
    return _make_nuts(potential_batch, step_size, max_depth, precond,
                      max_delta_energy)


def nuts(potential_fn: Callable, step_size, max_depth: int = 10,
         precond: Optional[object] = None,
         max_delta_energy: float = 1000.0) -> TransitionKernel:
    """Multinomial NUTS of one chain: `nuts_batched` over a one-chain
    batch."""
    return _one_chain(nuts_batched, potential_fn, step_size,
                      max_depth=max_depth, precond=precond,
                      max_delta_energy=max_delta_energy)


def _make_adaptive_nuts(potential_batch, eps0, num_adapt, target_accept,
                        max_depth, adapt_mass, max_delta, init_mass=None):
    vag = batch_value_and_grad(potential_batch)
    init = _adaptive_init(vag, eps0, init_mass)

    def step(generator, state):
        eps = _step_of(state.log_eps if state.step < num_adapt
                       else state.log_eps_avg)
        flat, unflat = _flatteners(state.position)
        q, u, g, info = _nuts_transition(
            _flat_vag(vag, unflat, flat), generator, flat(state.position),
            state.potential, flat(state.grad), eps, flat(state.mass_g),
            max_depth, max_delta)
        position, grad = unflat(q), unflat(g)
        (log_eps, log_eps_avg, h_avg, mu, mean, m2, mass_g) = \
            _warmup_advance(state, position, info["accept_prob"],
                            num_adapt, target_accept, adapt_mass)
        new_state = AdaptiveHMCState(
            position=position, potential=u, grad=grad, step=state.step + 1,
            log_eps=log_eps, log_eps_avg=log_eps_avg, h_avg=h_avg, mu=mu,
            mean=mean, m2=m2, mass_g=mass_g)
        info.update(potential=u, step_size=_step_of(log_eps_avg))
        return new_state, info

    return TransitionKernel(init, step)


def adaptive_nuts_batched(potential_batch: Callable, num_adapt: int,
                          step_size: float = 0.1,
                          target_accept: float = 0.8, max_depth: int = 10,
                          adapt_mass: bool = True,
                          max_delta_energy: float = 1000.0,
                          init_mass: Optional[object] = None
                          ) -> TransitionKernel:
    """Warmup-adaptive NUTS over the batch-potential contract: dual
    averaging of the step size on the trajectory's mean accept statistic
    and a Welford diagonal inverse mass, both frozen at `num_adapt` (set
    burn_in >= num_adapt), each chain its own.  `init_mass` seeds the
    warmup metric (on the stiff GP posterior pass `psgld_preconditioner`
    of a pSGLD warm-up: identity-mass warmup there drives every early
    tree to max depth)."""
    return _make_adaptive_nuts(potential_batch, step_size, num_adapt,
                               target_accept, max_depth, adapt_mass,
                               max_delta_energy, init_mass=init_mass)


def adaptive_nuts(potential_fn: Callable, num_adapt: int,
                  step_size: float = 0.1, target_accept: float = 0.8,
                  max_depth: int = 10, adapt_mass: bool = True,
                  max_delta_energy: float = 1000.0,
                  init_mass: Optional[object] = None) -> TransitionKernel:
    """Warmup-adaptive NUTS of one chain."""
    return _one_chain(adaptive_nuts_batched, potential_fn, num_adapt,
                      step_size=step_size, target_accept=target_accept,
                      max_depth=max_depth, adapt_mass=adapt_mass,
                      max_delta_energy=max_delta_energy,
                      init_mass=init_mass)
