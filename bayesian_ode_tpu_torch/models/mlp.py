"""MLP (neural-network) ODE vector field.

Counterpart of `bayesian_ode_tpu/models/mlp.py`: Linear(D, H)-ELU-
Linear(H, H)-ELU-Linear(H, D) with uniform(-0.5, 0.5) weights and zero
biases, the Bayesian closure SSE + L2 prior (reg * sum p^2), and the
incremental-sequence-learning curriculum T = min(3 + itr//5, len(t)).
Parameters are the JAX package's layer list [{'w', 'b'}, ...] of tensors;
`params_from_numpy` carries the JAX package's weights over.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.pytree import tree_leaves


def init_mlp(generator: torch.Generator, sizes: Sequence[int],
             dtype=torch.float64, device="cpu"):
    """Layer params [{'w', 'b'}] with uniform(-0.5, 0.5) weights from
    `generator` and zero biases."""
    params = []
    for d_in, d_out in zip(sizes[:-1], sizes[1:]):
        w = torch.rand((d_in, d_out), generator=generator, dtype=dtype,
                       device=device) - 0.5
        params.append({"w": w, "b": torch.zeros(d_out, dtype=dtype,
                                                device=device)})
    return params


def mlp_vector_field(params, t, x):
    """f(t, x) for x (..., D); ELU activations between layers (expm1, as
    jax.nn.elu)."""
    h = x
    for layer in params[:-1]:
        h = F.elu(torch.matmul(h, layer["w"]) + layer["b"])
    last = params[-1]
    return torch.matmul(h, last["w"]) + last["b"]


def curriculum_length(itr: int, total: int) -> int:
    """Incremental sequence learning: T = min(3 + itr//5, total)."""
    return min(3 + itr // 5, total)


def make_potential(x0, t, X, odeint_fn: Callable, reg: float = 0.5,
                   add_prior: bool = True, horizon=None) -> Callable:
    """SSE + L2 prior over one network's weights.

    `horizon`: optional number of observation times to fit (the
    curriculum's T); None uses the full trajectory.  x0 (N, D),
    X (N, T, D); `odeint_fn(func, x0, t)` chooses the solver.
    """
    T = X.shape[1] if horizon is None else int(horizon)
    t_, X_ = t[:T], X[:, :T, :]

    def potential(params):
        xode = odeint_fn(lambda tt, x: mlp_vector_field(params, tt, x),
                         x0, t_)
        loss = ((X_ - xode.movedim(0, 1)) ** 2).sum()
        if add_prior:
            loss = loss + reg * sum((p ** 2).sum()
                                    for p in tree_leaves(params))
        return loss

    return potential


def params_from_numpy(params, device="cpu", dtype=torch.float64):
    """The JAX package's layer list [{'w', 'b'}] of numpy arrays, with or
    without a leading chain axis, as the port's."""
    return [{k: torch.as_tensor(np.array(layer[k]), dtype=dtype,
                                device=device) for k in ("w", "b")}
            for layer in params]
