"""Meshes of shards and the sharded layout of trees of tensors.

Counterpart of `bayesian_ode_tpu/parallel/mesh.py`.  A mesh is an ordered
tuple of shards along named axes ('chain' for collective-free chain
parallelism, 'particle' for SVGD's and SMC's populations, 'replica' for a
temperature ladder), each shard with a torch device.  On the card
`make_mesh()` puts one shard on each CUDA device; a mesh may also put
several shards on one device (the CPU tests run 8 shards on the CPU, the
counterpart of the JAX suite's 8 virtual devices).

A mesh spans the processes of a fleet (`runtime.global_mesh`): this
process holds the shards [first_shard, first_shard + len(devices)) of the
mesh order, and the shards of the other processes are reached by
`torch.distributed` collectives only.  A tree split over a mesh axis is a
`Sharded`: this process's shards, each on its shard's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.pytree import tree_leaves, tree_map

__all__ = ["Mesh", "Sharded", "make_mesh", "make_mesh_2d", "replicated",
           "shard_leading_axis"]


@dataclass(frozen=True)
class Mesh:
    """Shards along named axes, in row-major order over `axis_sizes`.

    `devices` holds the device of each of THIS process's shards, which are
    the shards first_shard .. first_shard + len(devices) - 1 of the mesh;
    in a single process they are all of them."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    first_shard: int = 0

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("one size per axis name")
        if not self.devices:
            raise ValueError("a mesh needs at least one local shard")
        if self.first_shard + len(self.devices) > self.size:
            raise ValueError(f"shards {self.first_shard}.."
                             f"{self.first_shard + len(self.devices) - 1} "
                             f"lie outside a mesh of {self.size}")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def local_shards(self) -> range:
        """The global indices of this process's shards."""
        return range(self.first_shard, self.first_shard + len(self.devices))

    @property
    def spans_processes(self) -> bool:
        return len(self.devices) < self.size

    def coords(self, shard: int) -> Tuple[int, ...]:
        """A global shard index as its coordinates on the mesh axes."""
        return tuple(int(c) for c in np.unravel_index(shard,
                                                      self.axis_sizes))

    def axis_index(self, shard: int, axis: str) -> int:
        """The shard's position along `axis`."""
        return self.coords(shard)[self._axis_pos(axis)]

    def _axis_pos(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}; its axes are "
                             f"{self.axis_names}")
        return self.axis_names.index(axis)


def _cuda_devices():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a mesh defaults to the card; pass devices "
            "(e.g. devices=['cpu']) to put the shards on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _shard_devices(n_shards: Optional[int], devices: Optional[Sequence]):
    devs = [torch.device(d) for d in devices] if devices is not None \
        else _cuda_devices()
    if not devs:
        raise ValueError("devices must not be empty")
    n = len(devs) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return tuple(devs[i % len(devs)] for i in range(n))


def make_mesh(n_shards: Optional[int] = None, axis: str = "chain",
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh of `n_shards` shards in one process, dealt round-robin over
    `devices` (default: every CUDA device; `n_shards` defaults to one a
    device).  make_mesh(8, devices=["cpu"]) is 8 shards on the CPU;
    make_mesh(2, devices=["cuda:0"]) is two shards on one card."""
    devs = _shard_devices(n_shards, devices)
    return Mesh(devs, (axis,), (len(devs),))


def make_mesh_2d(n_chain: int, n_particle: int,
                 devices: Optional[Sequence] = None) -> Mesh:
    """(n_chain, n_particle) mesh with axes ('chain', 'particle') in one
    process, shards dealt round-robin over `devices` (default: every CUDA
    device).  A function sharded over one axis replicates over the other:
    the shards of one row of 'particle' share their chains."""
    devs = _shard_devices(n_chain * n_particle, devices)
    return Mesh(devs, ("chain", "particle"), (n_chain, n_particle))


class Sharded(NamedTuple):
    """A tree split over a mesh axis along its leaves' leading axis: one
    tree for each of this process's shards, in mesh order, on the shard's
    device (axis None: every shard holds the whole tree)."""

    shards: Tuple[Any, ...]
    mesh: Mesh
    axis: Optional[str]

    def local(self, device=None):
        """This process's shards joined along the leading axis (in one
        process, the whole tree), on `device` (default: the first local
        shard's); with axis None, the first shard's copy."""
        dev = torch.device(device) if device is not None \
            else self.mesh.devices[0]
        if self.axis is None:
            return tree_map(lambda l: l.to(dev), self.shards[0])
        seen, parts = set(), []
        for shard, tree in zip(self.mesh.local_shards, self.shards):
            k = self.mesh.axis_index(shard, self.axis)
            if k not in seen:   # one copy of each block along the axis
                seen.add(k)
                parts.append(tree)
        return tree_map(lambda *ls: torch.cat([l.to(dev) for l in ls]),
                        *parts)


def _leading(tree) -> int:
    leaves = tree_leaves(tree)
    if not leaves or any(l.dim() < 1 for l in leaves):
        raise ValueError("every leaf needs a leading axis to shard")
    n = leaves[0].shape[0]
    if any(l.shape[0] != n for l in leaves):
        raise ValueError("leaves disagree on the leading axis")
    return n


def _split(tree, mesh: Mesh, axis: str, blocks: int, first_block: int):
    """Shard a tree that holds `blocks` consecutive blocks of the axis,
    starting at block `first_block`, over this process's shards."""
    n = _leading(tree)
    if n % blocks:
        raise ValueError(f"leading axis {n} is not divisible by the "
                         f"{blocks} shards along {axis!r}")
    rows = n // blocks
    out = []
    for shard, dev in zip(mesh.local_shards, mesh.devices):
        k = mesh.axis_index(shard, axis) - first_block
        if not 0 <= k < blocks:
            raise ValueError(f"shard {shard} holds block "
                             f"{k + first_block}, outside this process's "
                             "rows")
        out.append(tree_map(
            lambda l, k=k, dev=dev: l[k * rows:(k + 1) * rows].to(dev),
            tree))
    return Sharded(tuple(out), mesh, axis)


def shard_leading_axis(tree, mesh: Mesh, axis: str = "chain") -> Sharded:
    """Split a tree of the GLOBAL leading axis over `axis`: each of this
    process's shards takes its block of rows, on its device (the other
    axes replicate).  Raises ValueError on an indivisible leading axis."""
    if isinstance(tree, Sharded):
        return tree
    return _split(tree, mesh, axis, mesh.shape[axis], 0)


def replicated(tree, mesh: Mesh) -> Sharded:
    """A copy of the whole tree on every one of this process's shards."""
    return Sharded(tuple(tree_map(lambda l, d=d: l.to(d), tree)
                         for d in mesh.devices), mesh, None)
