"""A solver loop's step replayed as one CUDA graph.

The adaptive loops step a batch in masked lockstep with a few hundred
small launches a step, each costing the host more than the card's work.
Without autograd a loop can instead commit each step in place to one
state and capture that step once: a replay launches the same kernels on
the same inputs, so the steps and values are the eager loop's, bit for
bit (`ode/vcabm.run_in_place`, `ode/adaptive._while_in_place`).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

# the steps a loop takes eagerly before it captures its step: a capture
# costs about three eager steps, and most of the adjoint's backward
# intervals end within a few steps
EAGER_STEPS = 16

# one memory pool a device for every capture, and the last graph captured
# there: it keeps the pool alive, and the next capture reuses its memory
# (a graph is never replayed once a later one is captured)
_LAST: Dict[int, tuple] = {}


def graphable(device) -> bool:
    """Whether a loop on `device` can replay its step as a CUDA graph: a
    CUDA device whose current stream is not the default one (a capture
    cannot run on the default stream, and one on a side stream would make
    the default stream wait on it wherever the step's VJPs reach tensors
    made there, as the adjoint's do) and that is not capturing already."""
    if torch.device(device).type != "cuda":
        return False
    current = torch.cuda.current_stream(device)
    return (current != torch.cuda.default_stream(device)
            and not torch.cuda.is_current_stream_capturing())


class GraphedStep:
    """A loop's step `body(eager)` (it commits the step in place): called
    as body(True) for its first `EAGER_STEPS` calls, where it may read
    the card from the host, then, with `graph`, as body(False),
    captured on the current stream at the next call and replayed from
    then on, so that a loop that ends within those steps pays no capture
    (and the eager steps set up the libraries' per-stream state, cuBLAS's
    workspace, before it).  `close()` ends the replays; the graph's
    memory goes to the next capture."""

    def __init__(self, body: Callable, graph: bool):
        self.body, self.graph = body, graph
        self.calls, self.cuda_graph = 0, None

    def __call__(self) -> None:
        if self.cuda_graph is None:
            if not self.graph or self.calls < EAGER_STEPS:
                self.calls += 1
                self.body(True)
                return
            device = torch.cuda.current_device()
            pool = (_LAST[device][0] if device in _LAST
                    else torch.cuda.graph_pool_handle())
            self.cuda_graph = torch.cuda.CUDAGraph()
            self.cuda_graph.capture_begin(pool=pool)
            self.body(False)
            self.cuda_graph.capture_end()
            _LAST[device] = (pool, self.cuda_graph)
        self.cuda_graph.replay()

    def close(self) -> None:
        self.cuda_graph = None
