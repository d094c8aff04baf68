"""Sharded Sequential Monte Carlo: the particles split over a mesh axis.

Counterpart of `bayesian_ode_tpu/parallel/smc.py`.  The likelihood, prior
and gradient evaluations and the MALA sweeps are parallel over particles;
the stage decisions (the next beta by ESS bisection, the log Z increment)
and systematic resampling are global.  `smc_sharded` runs
`samplers.smc` once on this process's block of the population (the
blocks of its shards joined, on its first shard's device); across the
processes of a fleet it passes `samplers.smc` a gather hook
(`collectives.ProcessGather`):

  - every process gathers the (N,) log likelihoods a stage, so every
    process computes the same next beta, conditional ESS and log Z
    increment;
  - resampling gathers the particles once and each process takes its own
    rows of the global index vector's resampled population;
  - every process's generator is seeded alike, draws the whole
    population's noise and keeps its own rows, so the sharded run
    reproduces the unsharded run's ladder, log Z and particles (bit for
    bit for row-independent batch potentials).

In a single process the call is the unsharded `samplers.smc`.  To spread
one population over several cards, run one process a card.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..samplers.smc import SMCResult, smc
from ..utils.pytree import tree_leaves
from .collectives import (ProcessGather, check_fleet_axis, local_blocks,
                          on_device)
from .mesh import Mesh, Sharded, shard_leading_axis

__all__ = ["smc_sharded"]


def smc_sharded(seed: int, log_lik_batch: Callable,
                log_prior_batch: Callable, prior_particles, mesh: Mesh,
                axis: str = "particle", **smc_kwargs) -> SMCResult:
    """`samplers.smc` with the particle axis split over `mesh`.

    `prior_particles` leaves carry a leading particle axis divisible by
    the axis size (or it is a `Sharded`).  The generator is
    `torch.Generator(device).manual_seed(seed)`, the unsharded run's with
    the same seed.  `smc_kwargs` go to `samplers.smc` (num_moves,
    target_ess, step_scale, target_accept, adapt_rate, max_stages).
    Returns the `SMCResult` of the unsharded call: `particles` and
    `log_lik` of this process's particles on its first shard's device,
    the scalars and stage diagnostics of the whole population."""
    check_fleet_axis(mesh, axis)
    k = mesh.shape[axis]
    if isinstance(prior_particles, Sharded):
        n = tree_leaves(prior_particles.shards[0])[0].shape[0] * k
    else:
        n = tree_leaves(prior_particles)[0].shape[0]
    if n % k:
        raise ValueError(f"particle count {n} must be divisible by the "
                         f"mesh axis size {k}")
    block = shard_leading_axis(prior_particles, mesh, axis).local()
    dev = mesh.devices[0]
    gather = None
    if mesh.spans_processes:
        blocks = local_blocks(mesh, axis)
        gather = ProcessGather(blocks[0][0] // len(blocks))
    with on_device(dev):
        return smc(torch.Generator(device=dev).manual_seed(int(seed)),
                   log_lik_batch, log_prior_batch, block, gather=gather,
                   **smc_kwargs)
