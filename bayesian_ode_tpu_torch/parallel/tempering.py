"""Mesh-sharded replica exchange: one temperature per shard.

Counterpart of `bayesian_ode_tpu/parallel/tempering.py` (in-batch PT is
`samplers/tempering.py`), for a ladder whose every replica's chain batch
fills a device: the ladder is a mesh axis, every shard runs the tempered
MALA move for its own beta on its chains, and an exchange round pairs
neighbouring shards.

Swaps need no coordinator:
- replica state is stored at unit temperature (x, U(x), grad U(x)), so an
  accepted swap adopts the partner's triple, with nothing to rescale or
  evaluate again;
- the even/odd pairing alternates round by round;
- both members of a pair draw the same uniforms, from a generator seeded
  by (seed, round, lower replica index).
The process's replicas move in turn, each on its shard's device; the
exchange joins their states and all-gathers them across the fleet (the
JAX package's `ppermute` of neighbours), and each replica takes its
partner's.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..samplers.base import batch_value_and_grad
from ..samplers.tempering import _check_betas
from ..utils.pytree import (tree_leaves, tree_map, tree_random_normal,
                            tree_sum_squares_per_chain, tree_unflatten)
from .chains import shard_generator, shard_seed
from .collectives import (check_fleet_axis, local_blocks, on_device,
                          process_all_gather)
from .mesh import Mesh, make_mesh

__all__ = ["run_parallel_tempering_sharded"]


def _partner(me: int, parity: int, K: int) -> int:
    """The replica that `me` pairs with in a round of this parity (itself
    when unpaired at an edge)."""
    cand = me + 1 if (me - parity) % 2 == 0 else me - 1
    return cand if (parity <= cand < K and me >= parity) else me


def _unpack(block, like):
    """The (C, F) columns of `block` reshaped into tensors like `like`'s."""
    out, col = [], 0
    for l in like:
        width = l[0].numel()
        out.append(block[:, col:col + width].reshape(l.shape))
        col += width
    return out


def _where(acc, a, b):
    return tree_map(lambda x, y: torch.where(
        acc.reshape(acc.shape + (1,) * (x.dim() - 1)), x, y), a, b)


def run_parallel_tempering_sharded(
        potential_fn: Callable, betas, step_size: float, x0, seed: int,
        num_samples: int, burn_in: int = 0, mesh: Optional[Mesh] = None,
        axis: str = "replica", swap_every: int = 1):
    """Replica-exchange MALA with one temperature per shard of `axis`.

    `betas`: a ladder with exactly `mesh.shape[axis]` entries, betas[0] =
    1.  `x0`: a (C, ...) tree of per-chain positions where every replica
    starts; `potential_fn` maps one chain's position to its potential.
    The tempered move takes step lr / beta_k on replica k, as the in-batch
    `samplers.parallel_tempering`.  Replica k's moves draw from
    `shard_generator(seed, k)`.  Returns (cold positions (num_samples, C,
    ...), info) with the cold replica's potential and acceptance
    (num_samples, C) and the swap acceptance averaged over the replicas,
    on the first local shard's device.  `mesh` defaults to one shard a
    CUDA device."""
    if mesh is None:
        mesh = make_mesh(axis=axis)
    K = int(mesh.shape[axis])
    betas_np = _check_betas(betas)
    if betas_np.size != K:
        raise ValueError(f"len(betas)={betas_np.size} must equal the "
                         f"'{axis}' mesh axis size {K}")
    check_fleet_axis(mesh, axis)
    betas32 = np.asarray(betas_np, np.float32)
    vag = batch_value_and_grad(torch.func.vmap(potential_fn))
    lr = float(step_size)
    replicas = [_Replica(me, mesh.devices[i], x0, float(betas32[me]),
                         float(np.float32(lr) / betas32[me]), seed, vag)
                for me, i in local_blocks(mesh, axis)]
    dev0 = mesh.devices[0]

    def swap(rnd):
        parity = rnd % 2
        # every replica's state along the axis, packed into one (C, F)
        # block a replica
        states = process_all_gather(torch.stack(
            [r.packed().to(dev0) for r in replicas]))
        for r in replicas:
            partner = _partner(r.me, parity, K)
            r.swap(states[partner], partner, float(betas32[partner]), rnd)

    for step in range(burn_in + num_samples):
        for r in replicas:
            with on_device(r.dev):
                r.move()
        if (step + 1) % swap_every == 0:
            swap((step + 1) // swap_every)
        if step >= burn_in:
            for r in replicas:
                r.record()
    # every replica's records along the axis: (K, S, C, ...)
    rec = [r.stacked() for r in replicas]
    xs, us, acc_m, acc_s = tree_map(
        lambda *ls: process_all_gather(torch.stack([l.to(dev0)
                                                    for l in ls])), *rec)
    cold = tree_map(lambda l: l[0], xs)
    info = {"potential": us[0], "accepted": acc_m[0],
            "swap_accepted": acc_s.to(torch.float32).mean(dim=0)}
    return cold, info


class _Replica:
    """One replica of the ladder on its shard's device: its state at unit
    temperature (x, U(x), grad U(x)), its tempered MALA move, its half of
    an exchange and its records."""

    def __init__(self, me, dev, x0, beta, lr_eff, seed, vag):
        self.me, self.dev, self.beta, self.lr_eff = me, dev, beta, lr_eff
        self.seed, self.vag = seed, vag
        self.x = tree_map(lambda l: l.to(dev), x0)
        with on_device(dev):
            self.u, self.g = vag(self.x)
        self.C, self.dtype = self.u.shape[0], self.u.dtype
        self.gen = shard_generator(seed, me, dev)
        self.no_swap = torch.zeros(self.C, dtype=torch.bool, device=dev)
        self.acc_m, self.acc_s = self.no_swap, self.no_swap
        self.records = []

    def move(self):
        x, u, g, beta, lr_eff = self.x, self.u, self.g, self.beta, \
            self.lr_eff
        scale = -1.0 / (4 * lr_eff)
        noise = tree_random_normal(self.gen, x)
        prop = tree_map(lambda p, g_, n: p - lr_eff * beta * g_
                        + np.sqrt(2.0 * lr_eff) * n, x, g, noise)
        u2, g2 = self.vag(prop)
        rev = tree_map(lambda a, b, g_: a - b + lr_eff * beta * g_,
                       x, prop, g2)
        fwd = tree_map(lambda a, b, g_: a - b + lr_eff * beta * g_,
                       prop, x, g)
        log_a = (beta * (u - u2) + scale * tree_sum_squares_per_chain(rev)
                 - scale * tree_sum_squares_per_chain(fwd))
        uni = torch.rand((self.C,), generator=self.gen, dtype=self.dtype,
                         device=self.dev)
        acc = torch.isfinite(log_a) & (torch.log(uni) < log_a)
        self.x, self.u, self.g = (_where(acc, prop, x),
                                  torch.where(acc, u2, u),
                                  _where(acc, g2, g))
        self.acc_m, self.acc_s = acc, self.no_swap

    def packed(self):
        return torch.cat([self.u[:, None]] + [
            l.reshape(self.C, -1) for l in tree_leaves((self.x, self.g))],
            dim=1)

    def swap(self, block, partner, beta_p, rnd):
        if partner == self.me:
            return
        block = block.to(self.dev)
        u_p = block[:, 0]
        x_p, g_p = tree_unflatten((self.x, self.g), _unpack(
            block[:, 1:], tree_leaves((self.x, self.g))))
        log_a = (self.beta - beta_p) * (self.u - u_p)
        pair_gen = torch.Generator(device=self.dev).manual_seed(
            shard_seed(self.seed, 2, rnd, min(self.me, partner)))
        usw = torch.rand((self.C,), generator=pair_gen, dtype=self.dtype,
                         device=self.dev)
        acc = torch.isfinite(log_a) & (torch.log(usw) < log_a)
        self.x, self.u, self.g = (_where(acc, x_p, self.x),
                                  torch.where(acc, u_p, self.u),
                                  _where(acc, g_p, self.g))
        self.acc_s = acc

    def record(self):
        self.records.append((self.x, self.u, self.acc_m, self.acc_s))

    def stacked(self):
        return tree_map(lambda *ls: torch.stack(ls), *self.records)
