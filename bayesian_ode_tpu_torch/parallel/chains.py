"""Chain-parallel sampling, the sharded GP solve and multi-shard SVGD.

Counterpart of `bayesian_ode_tpu/parallel/chains.py`.  Chains are
collective-free: each of this process's blocks of chains runs in turn on
its shard's device with a generator of its own, seeded from (seed, the
block's position on the axis), so a result depends only on the global
mesh, never on how many processes hold it.

SVGD is the one communicating algorithm of the module (all pairs of
particles): every step the process scores its block of particles,
all-gathers the positions and scores across the fleet, takes the
bandwidth from the gathered ensemble (the same median subsample as
`samplers.svgd`) and computes its own rows of phi in plain torch
(`samplers.stein.svgd_direction`), as the JAX package computes them in
XLA.

The JAX package caches its jitted sharded solve by the content of the
static quantities; eager torch has nothing to cache, so the port has no
counterpart of that cache.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..samplers.base import TransitionKernel, sample_chain, sample_chains
from ..samplers.stein import svgd_direction
from ..utils.pytree import tree_map
from .collectives import (check_fleet_axis, local_blocks, on_device,
                          process_all_gather)
from .mesh import Mesh, shard_leading_axis

__all__ = ["gp_dopri5_solve_sharded", "run_svgd_sharded",
           "sample_chain_sharded_batched", "sample_chains_sharded",
           "shard_generator", "shard_seed", "svgd_step_sharded"]


def shard_seed(seed: int, *path: int) -> int:
    """A 63-bit seed derived from (seed, *path) by numpy's SeedSequence:
    the seed of shard k on an axis is shard_seed(seed, k)."""
    words = np.random.SeedSequence([int(seed), *map(int, path)]) \
        .generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def shard_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of the shard at position `index` of its axis."""
    return torch.Generator(device=device).manual_seed(shard_seed(seed,
                                                                 index))


def _to(tree, device):
    return tree_map(lambda l: l.to(device) if torch.is_tensor(l) else l,
                    tree)


def _cat(parts, dim: int, device):
    return tree_map(lambda *ls: torch.cat([l.to(device) for l in ls], dim),
                    *parts)


def sample_chains_sharded(kernel: TransitionKernel, states, seed: int,
                          num_samples: int, mesh: Mesh, burn_in: int = 0,
                          thin: int = 1, axis: str = "chain"):
    """`samplers.sample_chains` with the chains split over `axis`.

    `states`: the global list of single-chain states (`init_chains`), its
    length divisible by the axis size.  Each block of chains runs on its
    shard's device with its own generator (`shard_generator`).  Returns
    (final_states, positions, infos) of this process's chains, the stacks
    with a leading chain axis on the first local shard's device."""
    k = mesh.shape[axis]
    if len(states) % k:
        raise ValueError(f"{len(states)} chains are not divisible by the "
                         f"{k} shards along {axis!r}")
    rows = len(states) // k
    out = []
    for pos, i in local_blocks(mesh, axis):
        dev = mesh.devices[i]
        with on_device(dev):
            mine = [_to(s, dev) for s in states[pos * rows:(pos + 1) * rows]]
            out.append(sample_chains(kernel, mine,
                                     shard_generator(seed, pos, dev),
                                     num_samples, burn_in, thin))
    dev = mesh.devices[0]
    finals = [s for o in out for s in o[0]]
    return (finals, _cat([o[1] for o in out], 0, dev),
            _cat([o[2] for o in out], 0, dev))


def sample_chain_sharded_batched(kernel: TransitionKernel, position0,
                                 seed: int, num_samples: int, mesh: Mesh,
                                 burn_in: int = 0, thin: int = 1,
                                 axis: str = "chain"):
    """A batched kernel's chain axis split over the mesh.

    Kernels on batch potentials (`samplers.sgld_batched`, `psgld_batched`,
    `mala_batched`, `asghmc_batched` over `ops.gp_rk4` or `ops.mlp_rk4`
    potentials, the NPSDE potential) carry the chain batch inside the
    state; each block of chains runs the whole sampling loop, init
    included, on its shard's device, so the kernels launch once a block.
    `position0` is a tree whose leaves' leading chain axis is divisible by
    the axis size, or a `Sharded`.  Block k draws from
    `shard_generator(seed, k)`, so its chains equal an unsharded run of
    them under that generator.  Returns (positions (num_samples, C, ...),
    potentials (num_samples, C)) of this process's chains, on its first
    shard's device; per-step scalar infos are block-local and dropped."""
    sharded = shard_leading_axis(position0, mesh, axis)
    out = []
    for pos, i in local_blocks(mesh, axis):
        dev = mesh.devices[i]
        with on_device(dev):
            _, positions, infos = sample_chain(
                kernel, kernel.init(sharded.shards[i]),
                shard_generator(seed, pos, dev), num_samples, burn_in, thin)
        out.append((positions, infos["potential"]))
    dev = mesh.devices[0]
    return (_cat([o[0] for o in out], 1, dev),
            _cat([o[1] for o in out], 1, dev))


def gp_dopri5_solve_sharded(A, x0, ts, static, mesh: Mesh,
                            axis: str = "chain", **solve_kwargs):
    """`ops.gp_dopri5.gp_dopri5_solve_whole` with the chain axis split
    over the mesh: each block of chains is solved on its shard's device
    (kernel K1 on the card, a launch a block), collective-free.

    A (C, M, 2) with C divisible by the axis size (or a `Sharded`); x0, ts
    and static are copied to every shard.  Returns (ys (T, C, N, 2),
    stats) of this process's chains on its first shard's device: the
    per-chain stats concatenated in mesh order and `reached_final_time`
    reduced over every block of every process."""
    from ..ops.gp_dopri5 import gp_dopri5_solve_whole

    sharded = shard_leading_axis(A, mesh, axis)
    out = []
    for _, i in local_blocks(mesh, axis):
        dev = mesh.devices[i]
        with on_device(dev):
            st = type(static)(*[_to(v, dev) for v in static])
            out.append(gp_dopri5_solve_whole(
                sharded.shards[i], x0.to(dev), ts.to(dev), st,
                **solve_kwargs))
    dev = mesh.devices[0]
    ys = torch.cat([o[0].to(dev) for o in out], dim=1)
    stats = {k: torch.cat([o[1][k].to(dev) for o in out])
             for k in out[0][1] if k != "reached_final_time"}
    reached = torch.tensor([all(bool(o[1]["reached_final_time"])
                                for o in out)])
    stats["reached_final_time"] = bool(process_all_gather(reached).all())
    return ys, stats


def run_svgd_sharded(potential_fn: Callable, particles, lr, num_steps: int,
                     mesh: Mesh, axis: str = "particle",
                     sigma: Optional[float] = None,
                     median_subsample: Optional[int] = 256):
    """`num_steps` SVGD updates with the particles split over `axis`.

    particles: (n, P) with n divisible by the axis size (or a `Sharded`);
    `potential_fn` maps one particle (P,) to its potential.  Each step the
    process scores its block of particles (torch.func.vmap of grad) on its
    first shard's device, all-gathers positions and scores across the
    fleet, and applies its rows of phi.  `median_subsample` as in
    `samplers.svgd` (equal values give the unsharded run's bandwidth).
    Returns this process's particles (n_local, P) on its first shard's
    device."""
    check_fleet_axis(mesh, axis)
    p_local = shard_leading_axis(particles, mesh, axis).local()
    score_fn = torch.func.vmap(torch.func.grad(potential_fn))
    with on_device(mesh.devices[0]):
        for _ in range(num_steps):
            scores = -score_fn(p_local)
            p_local = p_local + lr * svgd_direction(
                process_all_gather(p_local), process_all_gather(scores),
                sigma, median_subsample, rows=p_local)
    return p_local


def svgd_step_sharded(potential_fn: Callable, particles, lr, mesh: Mesh,
                      axis: str = "particle",
                      sigma: Optional[float] = None):
    """One sharded SVGD update (see `run_svgd_sharded`)."""
    return run_svgd_sharded(potential_fn, particles, lr, 1, mesh, axis,
                            sigma)
