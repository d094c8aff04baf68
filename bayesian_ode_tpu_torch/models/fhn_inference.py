"""FitzHugh-Nagumo parameter-inference model: theta = (a, b, c).

Counterpart of `bayesian_ode_tpu/models/fhn_inference.py`: direct
inference of the mechanistic parameters of

    V' = c (V - V^3/3 + R)
    R' = -(V - a + b R) / c          truth (a, b, c) = (0.2, 0.2, 3.0)

with a Gaussian likelihood at known observation noise and independent
Gaussian priors on (a, b, c).  theta is a dict {'a', 'b', 'c'} of scalars,
or of (C,) tensors on the fused path (`ops/fhn_dopri5.py`);
`params_from_numpy` carries the JAX package's theta over.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

_THIRD = 1.0 / 3.0

TRUE_THETA = {"a": 0.2, "b": 0.2, "c": 3.0}


def vector_field(theta, t, x):
    """FHN field at theta {'a','b','c'} (scalars or tensors broadcasting
    against x's leading axes); x (..., 2)."""
    p, w = x[..., 0:1], x[..., 1:2]
    a, b, c = theta["a"], theta["b"], theta["c"]
    return torch.cat([c * (p - p ** 3 * _THIRD + w), -(p - a + b * w) / c],
                     dim=-1)


def init_theta(generator: torch.Generator = None, scale: float = 0.0,
               dtype=torch.float64, device="cpu"):
    """Initial theta at the classic truth, optionally jittered by
    scale * N(0, 1) from `generator`."""
    theta = {k: torch.tensor(v, dtype=dtype, device=device)
             for k, v in TRUE_THETA.items()}
    if generator is not None and scale:
        theta = {k: v + scale * torch.randn((), generator=generator,
                                            dtype=dtype, device=device)
                 for k, v in theta.items()}
    return theta


def make_potential(x0, ts, X, solve: Callable, noise: float = 0.1,
                   prior_loc=(0.0, 0.0, 3.0), prior_scale=(1.0, 1.0, 1.0),
                   add_prior: bool = True):
    """Gaussian-likelihood posterior potential over one chain's theta:
    x0 (N, 2), ts (T,), X (N, T, 2) at known `noise`,
    `solve(func, x0, ts)` -> (T, N, 2).  c must stay positive.  The
    observations are taken in float32, as the JAX package takes them
    (a float64 trajectory promotes the residual)."""
    X = torch.as_tensor(X).to(torch.float32)
    inv_two_noise_sq = 0.5 / float(noise) ** 2

    def potential(theta):
        traj = solve(lambda tt, y: vector_field(theta, tt, y), x0, ts)
        loss = inv_two_noise_sq * ((X - traj.movedim(0, 1)) ** 2).sum()
        if add_prior:
            th = torch.stack([theta["a"], theta["b"], theta["c"]])
            loc = torch.as_tensor(prior_loc, dtype=th.dtype, device=th.device)
            scale = torch.as_tensor(prior_scale, dtype=th.dtype,
                                    device=th.device)
            loss = loss + 0.5 * (((th - loc) / scale) ** 2).sum()
        return loss

    return potential


def params_from_numpy(theta, device="cpu", dtype=torch.float64):
    """The JAX package's theta dict of numpy arrays (scalars or (C,)) as
    the port's."""
    return {k: torch.as_tensor(np.array(theta[k]), dtype=dtype,
                               device=device) for k in ("a", "b", "c")}
