"""Sampler kernel protocol and chain runner.

Counterpart of `bayesian_ode_tpu/samplers/base.py`.  A sampler is a
transition kernel over a position (a tree of tensors, `utils/pytree.py`):

    kernel.init(position)               -> state
    kernel.step(generator, state)       -> (state, info)

built from a potential U = -log posterior.  Randomness comes from an
explicit `torch.Generator`; `sample_chain` is a Python loop where the JAX
package uses `lax.scan`.  A batched kernel (`*_batched`, the batch
potential contract) carries every chain in one state and runs under
`sample_chain`; the single-chain kernels run under `init_chains` and
`sample_chains`, a loop over chains where the JAX package vmaps.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional

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


def sample_chains(kernel: TransitionKernel, states: List[Any],
                  generator: torch.Generator, num_samples: int,
                  burn_in: int = 0, thin: int = 1):
    """`sample_chain` of a single-chain kernel for each state of `states`
    (from `init_chains`), chain after chain from one generator.  Returns
    (final_states, positions, infos) with a leading chain axis on every
    leaf, the layout of the JAX package's vmap."""
    finals, positions, infos = [], [], []
    for state in states:
        final, pos, info = sample_chain(kernel, state, generator,
                                        num_samples, burn_in, thin)
        finals.append(final)
        positions.append(pos)
        infos.append(info)
    return finals, _stack(positions), _stack(infos)


def init_chains(kernel: TransitionKernel, generator: torch.Generator,
                init_position, num_chains: int, jitter: float = 0.0):
    """One single-chain kernel state a chain from a template position,
    each jittered by N(0, jitter^2) per leaf from `generator` for
    overdispersed starts.  Returns the list of states."""
    states = []
    for _ in range(num_chains):
        pos = init_position
        if jitter > 0.0:
            pos = tree_map(lambda x: x + jitter * torch.randn(
                x.shape, generator=generator, dtype=x.dtype,
                device=x.device), init_position)
        states.append(kernel.init(pos))
    return states


def potential_and_grad(potential_fn: Callable):
    """position -> (U, dU/dposition) of a single-chain potential."""
    def vag(position):
        with torch.enable_grad():
            leaves = tree_map(lambda x: x.detach().requires_grad_(True),
                              position)
            u = potential_fn(leaves)
            grads = torch.autograd.grad(u, tree_leaves(leaves))
        return u.detach(), tree_unflatten(position, grads)

    return vag


def _float_leaves(state):
    out = []
    for f in state:
        if f is None:
            continue
        out += [x for x in tree_leaves(f)
                if torch.is_tensor(x) and x.is_floating_point()]
    return out


def guard_finite(kernel: TransitionKernel) -> TransitionKernel:
    """Freeze a chain on its last finite state instead of propagating NaNs
    (the reference raises on a non-finite parameter and aborts): the
    wrapped kernel's new state commits only when every float leaf is
    finite, and `info["finite"]` says whether it did.  A rejected chain
    retries from its last finite state with fresh noise."""
    def step(generator, state):
        new_state, info = kernel.step(generator, state)
        finite = all(bool(torch.isfinite(x).all())
                     for x in _float_leaves(new_state))
        info = dict(info)
        info["finite"] = finite
        return (new_state if finite else state), info

    return TransitionKernel(kernel.init, step)


def guard_finite_batched(kernel: TransitionKernel,
                         n_chains: Optional[int] = None) -> TransitionKernel:
    """`guard_finite` per chain for a batched kernel: a chain's new state
    commits only if every one of its float entries is finite, so one
    divergent chain does not freeze the batch; `info["finite"]` is the
    (C,) mask.  C comes from the position at `init`, or `n_chains`.  Every
    tensor whose leading axis is a multiple k C of it holds k row-major
    blocks of the chains (row r belongs to chain r mod C: the chain axis
    itself, and parallel tempering's K C replica rows) and commits per
    chain, all its rows together (HAMCMC's pair masks with its pairs, the
    warmup's per-chain step sizes and masses with the positions); float
    tensors without that axis gate globally, and the shared host counters
    advance."""
    c_ref = [n_chains]

    def init(position):
        if c_ref[0] is None:
            c_ref[0] = int(tree_leaves(position)[0].shape[0])
        return kernel.init(position)

    def step(generator, state):
        new_state, info = kernel.step(generator, state)
        leaves = _float_leaves(new_state)
        C = c_ref[0] if c_ref[0] is not None else next(
            (x.shape[0] for x in leaves if x.dim() >= 1), 1)
        dev = leaves[0].device if leaves else None

        def rows(x):
            return x.dim() >= 1 and x.shape[0] > 0 and x.shape[0] % C == 0

        finite = torch.ones(C, dtype=torch.bool, device=dev)
        for x in leaves:
            if rows(x):
                finite = finite & torch.isfinite(x).reshape(
                    x.shape[0] // C, C, -1).all(dim=2).all(dim=0)
            else:
                finite = finite & torch.isfinite(x).all()

        def commit(new, old):
            if not torch.is_tensor(new):
                return new
            if rows(new):
                mask = finite.repeat(new.shape[0] // C)
                return torch.where(
                    mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new,
                    old)
            if new.is_floating_point():
                return torch.where(finite.all(), new, old)
            return new

        out = type(new_state)(*(
            tree_map(commit, n, o) if n is not None else None
            for n, o in zip(new_state, state)))
        info = dict(info)
        info["finite"] = finite
        return out, info

    return TransitionKernel(init, step)
