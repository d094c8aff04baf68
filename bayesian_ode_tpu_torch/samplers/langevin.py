"""Batched Langevin samplers of the main path: SGLD and pSGLD.

Counterpart of `bayesian_ode_tpu/samplers/langevin.py::sgld_batched` and
`psgld_batched` (the other Langevin kernels are ROADMAP queue 1 items 8
and 14).  Each takes the batch-potential contract: `potential_batch(params)`
maps a dict of tensors with a leading chain axis C to (C,) potentials in
one fused forward and backward pass.  The state carries the potential and
gradient at the current position, so a step costs exactly one pass, and
`info["potential"]` is the pre-step value.  Positions are updated out of
place: each step's position is kept by `sample_chain`.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..utils.pytree import tree_map, tree_random_normal
from . import schedules
from .base import TransitionKernel, batch_value_and_grad, langevin_noise_scale


class BatchLangevinState(NamedTuple):
    position: Any           # dict of tensors with a leading chain axis C
    potential: torch.Tensor  # (C,)
    grad: Any
    step: int


class BatchPreconditionedState(NamedTuple):
    position: Any
    potential: torch.Tensor
    grad: Any
    v: Any                  # EMA of squared gradients
    step: int


def sgld_batched(potential_batch: Callable, step_size) -> TransitionKernel:
    """SGLD over a whole chain batch per step:
    theta' = theta - lr * grad - sqrt(2 lr) * xi."""
    sched = schedules.resolve(step_size)
    vag = batch_value_and_grad(potential_batch)

    def init(position):
        u, g = vag(position)
        return BatchLangevinState(position, u, g, 0)

    def step(generator, state):
        lr = sched(state.step)
        noise = tree_random_normal(generator, state.position)
        scale = langevin_noise_scale(lr)
        new_pos = tree_map(lambda p, g, n: p - lr * g - scale * n,
                           state.position, state.grad, noise)
        u, g = vag(new_pos)
        info = {"potential": state.potential, "accepted": True,
                "step_size": lr}
        return BatchLangevinState(new_pos, u, g, state.step + 1), info

    return TransitionKernel(init, step)


def psgld_batched(potential_batch: Callable, step_size, alpha: float = 0.99,
                  lambda_: float = 1e-5, add_noise: bool = True
                  ) -> TransitionKernel:
    """Preconditioned SGLD over a whole chain batch per step:
    V <- alpha V + (1 - alpha) g^2;  G = 1 / (lambda + sqrt(V));
    theta' = theta - lr G g - sqrt(2 lr G) xi  (reference langevin.py:478-497).
    `add_noise=False` exists for deterministic equivalence tests."""
    sched = schedules.resolve(step_size)
    vag = batch_value_and_grad(potential_batch)

    def init(position):
        u, g = vag(position)
        return BatchPreconditionedState(position, u, g,
                                        tree_map(torch.zeros_like, g), 0)

    def step(generator, state):
        lr = sched(state.step)
        v = tree_map(lambda v_, g_: alpha * v_ + (1 - alpha) * g_ ** 2,
                     state.v, state.grad)
        G = tree_map(lambda v_: 1.0 / (lambda_ + torch.sqrt(v_)), v)
        if add_noise:
            noise = tree_random_normal(generator, state.position)
            scale = langevin_noise_scale(lr)
            new_pos = tree_map(
                lambda p, g_, G_, n: p - lr * G_ * g_
                - scale * torch.sqrt(G_) * n,
                state.position, state.grad, G, noise)
        else:
            new_pos = tree_map(lambda p, g_, G_: p - lr * G_ * g_,
                               state.position, state.grad, G)
        u, g = vag(new_pos)
        info = {"potential": state.potential, "accepted": True,
                "step_size": lr}
        return (BatchPreconditionedState(new_pos, u, g, v, state.step + 1),
                info)

    return TransitionKernel(init, step)
