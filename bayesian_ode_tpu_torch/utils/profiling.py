"""Profiling helpers (counterpart of `bayesian_ode_tpu/utils/profiling.py`):
device-synchronised wall-clock timing and a profiler trace.

`device_timer` synchronises the card at both edges of the block, since
CUDA launches return before the work is done.  `torch_trace` takes the
place of the JAX package's `xla_trace`: a `torch.profiler` window over
the CPU and, where there is one, the card, written as a Chrome trace.
`time_compiled` is the counterpart of the JAX helper of the same name:
the first call (which builds kernels and warms caches) apart from the
steady calls.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_timer(label: str = "", device=None, echo: bool = True):
    """Wall-clock a block, synchronising `device` (a CUDA device; None or
    the CPU: no synchronisation) at both edges.  The yielded dict gets
    "seconds" when the block ends."""
    _sync(device)
    start = time.perf_counter()
    result = {}
    yield result
    _sync(device)
    result["seconds"] = time.perf_counter() - start
    if echo and label:
        print(f"[timer] {label}: {result['seconds']:.4f}s")


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """A torch.profiler window over the block (CPU activity, and the card's
    where there is one), exported to {log_dir}/trace.json for
    chrome://tracing or Perfetto.  Yields the profiler (its
    `key_averages()` sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_compiled(fn: Callable, *args, iters: int = 10, device=None):
    """(first_call_seconds, steady_seconds_per_call) of fn(*args), with
    `device` synchronised after the first call and after the steady
    calls."""
    t0 = time.perf_counter()
    fn(*args)
    _sync(device)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(device)
    return first_s, (time.perf_counter() - t0) / iters
