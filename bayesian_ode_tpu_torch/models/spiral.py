"""Spiral neural-ODE demo: the y^3-net field.

Counterpart of `bayesian_ode_tpu/models/spiral.py`.  True dynamics
dy/dt = y^3 A with A = [[-0.1, 2], [-2, -0.1]]; the learned field is
Linear(2, H)-Tanh-Linear(H, 2) applied to y^3, with N(0, 0.1) weights and
zero biases (H = 50 in the demo and in the driver).  Parameters are a dict
{'w1' (2, H), 'b1' (H,), 'w2' (H, 2), 'b2' (2,)}, with a leading chain axis
on the fused path; `params_from_numpy` carries the JAX package's weights
over.  `get_batch` and `make_loss` are the demo's minibatch training
helpers (random sub-trajectories, mean absolute error).
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


def get_batch(generator: torch.Generator, true_y, t, batch_time: int = 10,
              batch_size: int = 20):
    """Random sub-trajectory minibatch: batch_size distinct start indices
    s from `generator` (without replacement) and
    (batch_y0 (B, 2), batch_t (batch_time,), batch_y (batch_time, B, 2))
    with batch_y[i] = true_y[s + i]."""
    n = true_y.shape[0] - batch_time
    s = torch.randperm(n, generator=generator)[:batch_size].to(
        true_y.device)
    batch_y = torch.stack([true_y[s + i] for i in range(batch_time)])
    return true_y[s], t[:batch_time], batch_y


def make_loss(odeint_fn: Callable, batch_y0, batch_t, batch_y):
    """mean |pred - batch| of the field at params, with
    `odeint_fn(func, y0, t)` the solver (the demo's `odeint_adjoint`)."""
    def loss(params):
        pred = odeint_fn(lambda tt, y: vector_field(params, tt, y),
                         batch_y0, batch_t)
        return (pred - batch_y).abs().mean()

    return loss


def params_from_numpy(params, device="cpu", dtype=torch.float64):
    """The JAX package's spiral parameter dict of numpy arrays, with or
    without a leading chain axis, as the port's."""
    return {k: torch.as_tensor(np.array(params[k]), dtype=dtype,
                               device=device)
            for k in ("w1", "b1", "w2", "b2")}
