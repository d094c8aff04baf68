"""Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move).

Counterpart of `bayesian_ode_tpu/samplers/ensemble.py`.  The stretch move
needs only the potential, no gradient, and its affine invariance means no
preconditioning is ever needed.  The walker ensemble is the batch: each
step runs two red/black half-sweeps, in which the walkers of one half move
by

    y_i = x_j + z (x_i - x_j),   z ~ g(z) propto 1/sqrt(z) on [1/a, a],
    accepted with min(1, z^(d-1) exp(U(x_i) - U(y_i))),

x_j a walker drawn uniformly from the other, frozen half (the parallel
variant of Foreman-Mackey et al. 2013, section 3), so a sweep is one
potential evaluation over N/2 rows and a step two, whatever N.

Draws per half-sweep: the partners (`torch.randint`), then z's and the
Metropolis uniforms (`torch.rand`).  Use at least 2 d + 2 walkers.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..utils.pytree import tree_leaves, tree_map
from .base import TransitionKernel
from .langevin import _where_per_chain

__all__ = ["EnsembleState", "stretch_move"]


class EnsembleState(NamedTuple):
    position: Any              # walker-major tree (N, ...)
    potential: torch.Tensor    # (N,) cached U(x)
    step: int


def _dim_per_walker(position) -> int:
    return sum(math.prod(x.shape[1:]) for x in tree_leaves(position))


def stretch_move(potential_batch: Callable, a: float = 2.0
                 ) -> TransitionKernel:
    """The Goodman-Weare stretch move over a walker ensemble.

    `potential_batch` follows the batch-potential contract (leaves with a
    leading walker axis R -> (R,) potentials) and is called without
    gradients.  `a > 1` is the stretch scale (2.0 the usual default;
    smaller is timider, with higher acceptance).  The ensemble size N (the
    leading axis of the position given to `init`) must be even and at
    least 4."""
    if a <= 1.0:
        raise ValueError("stretch scale must satisfy a > 1")

    def init(position):
        n = tree_leaves(position)[0].shape[0]
        if n % 2:
            raise ValueError("ensemble size must be even (red/black halves)")
        if n < 4:
            raise ValueError("need at least 4 walkers")
        with torch.no_grad():
            u = potential_batch(position)
        return EnsembleState(position=position, potential=u, step=0)

    def half_sweep(generator, movers, frozen, u_movers, d):
        """Stretch-update `movers` against the `frozen` half: (new
        positions, new potentials, accept mask)."""
        h = u_movers.shape[0]
        dt, dev = u_movers.dtype, u_movers.device
        j = torch.randint(0, h, (h,), generator=generator, device=dev)
        partners = tree_map(lambda x: x[j], frozen)
        # inverse-cdf draw from g(z) propto 1/sqrt(z) on [1/a, a]
        u01 = torch.rand((h,), generator=generator, dtype=dt, device=dev)
        z = ((a - 1.0) * u01 + 1.0) ** 2 / a
        prop = tree_map(
            lambda xj, xi: xj + z.reshape((h,) + (1,) * (xi.dim() - 1))
            .to(xi.dtype) * (xi - xj), partners, movers)
        with torch.no_grad():
            u_prop = potential_batch(prop)
        log_alpha = (d - 1.0) * torch.log(z) + u_movers - u_prop
        uniform = torch.rand((h,), generator=generator, dtype=dt,
                             device=dev)
        accept = torch.isfinite(log_alpha) & (torch.log(uniform) < log_alpha)
        return (_where_per_chain(accept, prop, movers),
                torch.where(accept, u_prop, u_movers), accept)

    def step(generator, state):
        h = state.potential.shape[0] // 2
        d = _dim_per_walker(state.position)
        red = tree_map(lambda x: x[:h], state.position)
        black = tree_map(lambda x: x[h:], state.position)
        red, u_red, acc_r = half_sweep(generator, red, black,
                                       state.potential[:h], d)
        black, u_black, acc_b = half_sweep(generator, black, red,
                                           state.potential[h:], d)
        position = tree_map(lambda r, b: torch.cat([r, b], dim=0), red,
                            black)
        potential = torch.cat([u_red, u_black])
        info = {"potential": potential,
                "accepted": torch.cat([acc_r, acc_b])}
        return EnsembleState(position, potential, state.step + 1), info

    return TransitionKernel(init, step)
