"""Fleet runtime: `torch.distributed` set-up, the global mesh, host-local IO.

Counterpart of `bayesian_ode_tpu/parallel/runtime.py`.  The reference
scales out with SLURM job arrays of independent processes; the JAX
package runs one SPMD program over a pod.  Here every process of a fleet
runs the same script: `init_runtime` joins it to the default
`torch.distributed` process group, `global_mesh` lays the shards of every
process out in one mesh (process p's shards follow process p - 1's), and
`process_slice` hands each process its block of an item list.

A single process needs no set-up: `init_runtime()` does nothing there,
and every helper below degrades to the local mesh.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .collectives import process_all_gather
from .mesh import Mesh, Sharded, _split, make_mesh

__all__ = ["Runtime", "coordinator_only", "global_mesh",
           "host_local_to_global", "init_runtime", "process_slice"]


@dataclass(frozen=True)
class Runtime:
    """What a launched process knows about the fleet it belongs to."""

    process_index: int
    process_count: int
    n_local_devices: int
    n_global_devices: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def _cluster_env_present() -> bool:
    """True when a launcher's environment advertises a fleet of more than
    one process: torchrun's WORLD_SIZE or SLURM's SLURM_NTASKS above 1."""
    for var in ("WORLD_SIZE", "SLURM_NTASKS"):
        if int(os.environ.get(var, "1") or "1") > 1:
            return True
    return False


def _local_cuda_devices() -> list:
    """The cards this process uses: its own card under a launcher that
    starts one process a card (LOCAL_RANK), else every visible card."""
    if not torch.cuda.is_available():
        return []
    n = torch.cuda.device_count()
    if "LOCAL_RANK" in os.environ and _world() > 1:
        return [torch.device("cuda", int(os.environ["LOCAL_RANK"]) % n)]
    return [torch.device("cuda", i) for i in range(n)]


def _world() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _current_runtime() -> Runtime:
    """The fleet as this process sees it now (no set-up)."""
    n_local = len(_local_cuda_devices())
    total = n_local
    if _world() > 1:
        total = int(process_all_gather(torch.tensor([n_local])).sum())
    return Runtime(_rank(), _world(), n_local, total)


def init_runtime(coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 backend: Optional[str] = None,
                 device="cuda") -> Runtime:
    """Join this process to its fleet; return what it knows.

    - Explicit arguments (coordinator "host:port", num_processes,
      process_id) name the fleet; `tcp://host:port` is its rendezvous.
    - Under torchrun (WORLD_SIZE > 1) or SLURM (SLURM_NTASKS > 1) pass
      nothing: the rendezvous is `env://` (MASTER_ADDR, MASTER_PORT), the
      rank and size come from RANK/WORLD_SIZE or SLURM_PROCID/SLURM_NTASKS.
    - A single process (no arguments, no launcher): nothing to do.

    The backend is `backend`, else chosen from `device`'s type up front:
    nccl for CUDA, gloo for the CPU (nccl takes one process a card; two
    processes on one card use gloo).  Safe to call more than once: a
    joined process returns the current state."""
    want_multi = (coordinator_address is not None
                  or num_processes is not None or _cluster_env_present())
    if want_multi and not (dist.is_available() and dist.is_initialized()):
        if backend is None:
            backend = "nccl" if torch.device(device).type == "cuda" \
                else "gloo"
        if coordinator_address is not None:
            kwargs = dict(init_method=f"tcp://{coordinator_address}",
                          world_size=int(num_processes),
                          rank=int(process_id))
        elif int(os.environ.get("SLURM_NTASKS", "1") or "1") > 1 \
                and "WORLD_SIZE" not in os.environ:
            kwargs = dict(init_method="env://",
                          world_size=int(os.environ["SLURM_NTASKS"]),
                          rank=int(os.environ["SLURM_PROCID"]))
        else:
            kwargs = dict(init_method="env://")
        if backend == "nccl":
            devs = _local_cuda_devices()
            if devs:
                torch.cuda.set_device(devs[0])
        dist.init_process_group(backend=backend, **kwargs)
    return _current_runtime()


def global_mesh(axis: str = "chain", devices: Optional[Sequence] = None
                ) -> Mesh:
    """1-D mesh over the shards of every process: this process's shards on
    `devices` (default: its cards, one shard a card), after the shards of
    the lower ranks.  Every process must hold the same number of shards.
    In a single process this is `make_mesh(devices=devices)`."""
    local = list(devices) if devices is not None else _local_cuda_devices()
    if not local:
        raise RuntimeError(
            "no CUDA device: pass devices (e.g. devices=['cpu'] * 4) to "
            "put this process's shards on the CPU")
    if _world() == 1:
        return make_mesh(len(local), axis, local)
    counts = process_all_gather(torch.tensor([len(local)]))
    if bool((counts != len(local)).any()):
        raise ValueError(f"processes hold different shard counts: "
                         f"{counts.tolist()}")
    return Mesh(tuple(torch.device(d) for d in local), (axis,),
                (len(local) * _world(),), _rank() * len(local))


def process_slice(n_total: int, runtime: Optional[Runtime] = None) -> slice:
    """This process's contiguous block of `n_total` work items: process p
    of P owns [p n // P, (p + 1) n // P).  Block sizes differ by at most
    one; every item belongs to exactly one process."""
    if runtime is None:
        runtime = Runtime(_rank(), _world(), 0, 0)
    p, P_ = runtime.process_index, runtime.process_count
    return slice(p * n_total // P_, (p + 1) * n_total // P_)


def host_local_to_global(tree, mesh: Mesh, axis: str = "chain") -> Sharded:
    """This process's block of the leading axis (the rows of its own
    shards, e.g. the chains of its `process_slice`) split over its shards.
    In a single process it is `shard_leading_axis`."""
    blocks = sorted({mesh.axis_index(s, axis) for s in mesh.local_shards})
    if blocks != list(range(blocks[0], blocks[0] + len(blocks))):
        raise ValueError(f"this process's shards along {axis!r} are not "
                         "contiguous")
    return _split(tree, mesh, axis, len(blocks), blocks[0])


def coordinator_only(fn):
    """Run `fn()` on process 0 only (logging, checkpoint writes, plots);
    the other processes get None."""
    if _rank() == 0:
        return fn()
    return None
