"""Sampler kernel protocol and chain runner.

Counterpart of `bayesian_ode_tpu/samplers/base.py`.  A sampler is a
transition kernel over a position (a tree of tensors, `utils/pytree.py`):

    kernel.init(position)               -> state
    kernel.step(generator, state)       -> (state, info)

built from a potential U = -log posterior.  Randomness comes from an
explicit `torch.Generator`; `sample_chain` is a Python loop where the JAX
package uses `lax.scan`.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..utils.pytree import tree_leaves, tree_map, tree_unflatten


class TransitionKernel(NamedTuple):
    init: Callable[[Any], Any]
    step: Callable[[torch.Generator, Any], tuple]


def _stack(items):
    """Stack a list of infos/positions (tensors, floats, bools or dicts
    and lists of them) along a new leading axis."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([it[i] for it in items])
                           for i in range(len(first)))
    if torch.is_tensor(first):
        return torch.stack(items)
    return torch.tensor(items)


def sample_chain(kernel: TransitionKernel, state, generator: torch.Generator,
                 num_samples: int, burn_in: int = 0, thin: int = 1):
    """Run `burn_in` steps, then collect `num_samples` positions, keeping
    every `thin`-th step's position.

    Returns (final_state, positions, infos): positions stacks
    state.position over samples and infos stacks the info dicts (each
    entry with a leading samples axis).
    """
    for _ in range(burn_in):
        state, _ = kernel.step(generator, state)
    positions, infos = [], []
    for _ in range(num_samples):
        for _ in range(thin):
            state, info = kernel.step(generator, state)
        positions.append(state.position)
        infos.append(info)
    return state, _stack(positions), _stack(infos)


def batch_value_and_grad(potential_batch: Callable):
    """Value-and-grad for the batch-potential contract.

    `potential_batch(params)` maps tensors with a leading chain axis C to
    (C,) potentials in one call (the fused kernels need the whole batch).
    Returns `vag(position) -> ((C,) potentials, grads)` from one forward
    and one backward pass: the gradient of the summed potentials is the
    stack of per-chain gradients, since chains are independent.
    """

    def vag(position):
        with torch.enable_grad():
            leaves = tree_map(lambda x: x.detach().requires_grad_(True),
                              position)
            pots = potential_batch(leaves)
            grads = torch.autograd.grad(pots.sum(), tree_leaves(leaves))
        return pots.detach(), tree_unflatten(position, grads)

    return vag


def langevin_noise_scale(lr: float) -> float:
    """Langevin noise std sqrt(2 * lr): the reference draws
    Normal(0, 1/sqrt(0.5*lr)) and multiplies by lr."""
    return math.sqrt(2.0 * lr)
