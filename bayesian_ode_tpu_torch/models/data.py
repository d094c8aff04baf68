"""Trajectory dataset generation for the Bayesian ODE experiments.

Counterpart of `bayesian_ode_tpu/models/data.py`: N trajectories from
random initial conditions integrated with the true dynamics, X clean, Y
with additive Gaussian noise.  The draws come from a `torch.Generator`
seeded with `seed`, so the numbers differ from the JAX package's
`jax.random` draws for the same seed; tests hand the JAX dataset arrays to
both packages instead.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ode import odeint
from .dynamics import DYNAMICS


def make_dataset(seed: int = 0, ode: str = "vdp", N: int = 5, T: int = 40,
                 t_max: float = 10.0, noise: float = 0.1,
                 x0_scale: float = 2.0, method: str = "dopri5",
                 rtol: float = 1e-7, atol: float = 1e-9, device="cpu",
                 dtype=torch.float64) -> Dict:
    """Solve the true dynamics from N random x0 and add observation noise."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f = DYNAMICS[ode]
    t = torch.linspace(0.0, t_max, T, dtype=dtype, device=device)
    x0 = x0_scale * torch.randn((N, 2), generator=gen, dtype=dtype,
                                device=device)
    X = odeint(f, x0, t, rtol, atol, method=method)       # (T, N, 2)
    X = X.movedim(0, 1)                                    # (N, T, 2)
    Y = X + noise * torch.randn(X.shape, generator=gen, dtype=dtype,
                                device=device)
    return {"N": N, "R": 1, "noise": noise, "x0": x0, "t": t, "X": X,
            "Y": Y, "ODE": ode}
