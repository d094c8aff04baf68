"""Spiral neural-ODE demo: the y^3-net field.

Counterpart of `bayesian_ode_tpu/models/spiral.py`.  True dynamics
dy/dt = y^3 A with A = [[-0.1, 2], [-2, -0.1]]; the learned field is
Linear(2, H)-Tanh-Linear(H, 2) applied to y^3, with N(0, 0.1) weights and
zero biases (H = 50 in the demo and in the driver).  Parameters are a dict
{'w1' (2, H), 'b1' (H,), 'w2' (H, 2), 'b2' (2,)}, with a leading chain axis
on the fused path; `params_from_numpy` carries the JAX package's weights
over.  The minibatch training helpers (`get_batch`, `make_loss`) are
ROADMAP queue 1 item 11.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.pytree import tree_leaves

TRUE_A = np.asarray([[-0.1, 2.0], [-2.0, -0.1]])
TRUE_Y0 = np.asarray([2.0, 0.0])


def true_field(t, y):
    return torch.matmul(y ** 3, torch.as_tensor(TRUE_A, dtype=y.dtype,
                                                device=y.device))


def init_params(generator: torch.Generator, hidden: int = 50,
                dtype=torch.float64, device="cpu"):
    """N(0, 0.1) weights from `generator` (w1 then w2) and zero biases."""
    def normal(shape):
        return 0.1 * torch.randn(shape, generator=generator, dtype=dtype,
                                 device=device)

    return {"w1": normal((2, hidden)),
            "b1": torch.zeros(hidden, dtype=dtype, device=device),
            "w2": normal((hidden, 2)),
            "b2": torch.zeros(2, dtype=dtype, device=device)}


def vector_field(params, t, y):
    h = torch.tanh(torch.matmul(y ** 3, params["w1"]) + params["b1"])
    return torch.matmul(h, params["w2"]) + params["b2"]


def make_potential(x0, ts, X, solve: Callable, reg: float = 0.5,
                   add_prior: bool = True):
    """SSE + L2 posterior potential of one chain's spiral field over N
    shared initial points: x0 (N, 2), ts (T,), X (N, T, 2) observations,
    `solve(func, x0, ts)` -> (T, N, 2)."""
    def potential(params):
        traj = solve(lambda tt, y: vector_field(params, tt, y), x0, ts)
        loss = ((X - traj.movedim(0, 1)) ** 2).sum()
        if add_prior:
            loss = loss + reg * sum((v ** 2).sum()
                                    for v in tree_leaves(params))
        return loss

    return potential


def params_from_numpy(params, device="cpu", dtype=torch.float64):
    """The JAX package's spiral parameter dict of numpy arrays, with or
    without a leading chain axis, as the port's."""
    return {k: torch.as_tensor(np.array(params[k]), dtype=dtype,
                               device=device)
            for k in ("w1", "b1", "w2", "b2")}
