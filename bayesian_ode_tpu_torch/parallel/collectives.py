"""This process's blocks of a mesh axis, and all-gathers across a fleet.

The port's counterpart of `jax.shard_map` with `lax.all_gather`.  Within
a process no shard waits on another: a collective-free function runs on
each of the process's blocks in turn (`local_blocks`, on the block's
device), and a communicating algorithm (SVGD, SMC) runs once on the
process's whole block, whose gather within the process is the block
itself.  Across the processes of a fleet the gather is
`torch.distributed.all_gather` (`process_all_gather`).  The gloo backend
gathers through the host: a CUDA tensor is copied to the CPU before the
collective and back after it (nccl gathers on the card).
"""
from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["ProcessGather", "local_blocks", "on_device",
           "process_all_gather"]


def process_all_gather(t: torch.Tensor) -> torch.Tensor:
    """Concatenate `t` of every process of the default group along the
    leading axis, in rank order (every process passes one shape); `t`
    itself in a single process."""
    if not dist.is_available() or not dist.is_initialized() \
            or dist.get_world_size() == 1:
        return t
    src = t.contiguous()
    if dist.get_backend() == "gloo" and src.is_cuda:
        src = src.cpu()                 # gloo gathers on the host
    elif dist.get_backend() == "nccl" and not src.is_cuda:
        src = src.cuda()                # nccl gathers on the card
    is_bool = src.dtype == torch.bool
    if is_bool:
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    out = torch.cat(parts).to(t.device)
    return out.bool() if is_bool else out


class ProcessGather:
    """`samplers.smc`'s gather hook across a fleet: every process's block
    of the population concatenated in rank order; this process's block is
    block `index` of it (blocks of equal size)."""

    def __init__(self, index: int):
        self.index = index

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return process_all_gather(t)


def local_blocks(mesh: Mesh, axis: str) -> List[Tuple[int, int]]:
    """(k, i) for each position k along `axis` that this process holds, in
    mesh order and once each (the shards that differ only along the other
    axes share their block): i is the local index of its first shard, into
    `mesh.devices` and a `Sharded`'s shards."""
    out, seen = [], set()
    for i, shard in enumerate(mesh.local_shards):
        k = mesh.axis_index(shard, axis)
        if k not in seen:
            seen.add(k)
            out.append((k, i))
    return out


def check_fleet_axis(mesh: Mesh, axis: str) -> None:
    """A collective across processes gathers along `axis` only, so the
    other axes of a mesh that spans processes must have size 1."""
    pos = mesh._axis_pos(axis)
    if mesh.spans_processes and any(
            s != 1 for j, s in enumerate(mesh.axis_sizes) if j != pos):
        raise ValueError("across processes a collective runs over a mesh "
                         f"whose only axis of size > 1 is {axis!r}")


def on_device(device: torch.device):
    """The device as the current CUDA device (the kernels' wrappers launch
    on the current device's stream); nothing for the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)
