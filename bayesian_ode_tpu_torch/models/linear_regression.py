"""Bayesian linear regression toy (counterpart of
`bayesian_ode_tpu/models/linear_regression.py`; reference
notebooks/jai/linear_reg.py).

1-D linear model y = w x + b + eps, a smoke target for MALA/SGLD/MMALA
with the SoftAbs metric; the posterior is Gaussian, so sampler output can
be checked in closed form.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def make_data(generator: torch.Generator, n: int = 50, w: float = 2.0,
              b: float = -0.7, noise: float = 0.3, dtype=torch.float32,
              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ~ U(-2, 2) and y = w x + b + noise N(0, 1), from `generator`."""
    x = torch.rand((n,), generator=generator, dtype=dtype,
                   device=device) * 4.0 - 2.0
    y = w * x + b + noise * torch.randn((n,), generator=generator,
                                        dtype=dtype, device=device)
    return x, y


def make_potential(x, y, noise: float = 0.3, prior_scale: float = 10.0
                   ) -> Callable:
    """U(theta) = NLL + Gaussian prior, theta = [w, b]."""

    def potential(theta):
        pred = theta[0] * x + theta[1]
        nll = ((y - pred) ** 2).sum() / (2.0 * noise**2)
        prior = (theta**2).sum() / (2.0 * prior_scale**2)
        return nll + prior

    return potential


def exact_posterior(x, y, noise: float = 0.3, prior_scale: float = 10.0
                    ) -> Dict[str, torch.Tensor]:
    """Closed-form Gaussian posterior over [w, b]."""
    X = torch.stack([x, torch.ones_like(x)], dim=1)
    eye = torch.eye(2, dtype=x.dtype, device=x.device)
    prec = X.T @ X / noise**2 + eye / prior_scale**2
    cov = torch.linalg.inv(prec)
    mean = cov @ (X.T @ y) / noise**2
    return {"mean": mean, "cov": cov}
