"""2-D toy target densities for sampler visualization and validation.

Counterpart of `bayesian_ode_tpu/models/toy_densities.py` (reference:
scripts/toy/toy_plots.py:14-123).  Each returns a potential
U(theta) = -log p(x, y) over theta = [x, y] (constants dropped), the
reference's closures; theta may carry leading batch axes (..., 2).
"""
from __future__ import annotations

import numpy as np
import torch


def banana_potential(a: float = 0.2, b: float = 2.0, c: float = 1.0):
    """0.5*(a x^2 + (b y + c x^2)^2) (toy_plots.py:18-21)."""

    def potential(theta):
        x, y = theta[..., 0], theta[..., 1]
        return 0.5 * (a * x * x + (b * y + c * x * x) ** 2)

    return potential


def gaussian_potential(sigma1: float = 1.0, sigma2: float = 2.0,
                       corr: float = 0.5, mean=(2.0, 4.0)):
    """Correlated Gaussian centered at (2, 4) (toy_plots.py:94-99); the
    reference's exponent lacks the global 1/2 factor, kept as is."""

    def potential(theta):
        x_ = (theta[..., 0] - mean[0]) / sigma1
        y_ = (theta[..., 1] - mean[1]) / sigma2
        return (x_**2 + y_**2 - 2 * corr * x_ * y_) / (2 * (1 - corr**2))

    return potential


def mixture_potential(mixture=(0.5, 0.5), means=((-1, -1), (1, 1)),
                      sigmas=((1, 0.5), (0.5, 1)), corr=(0.5, -0.5)):
    """-log of a Gaussian mixture (toy_plots.py:46-62), the reference's
    un-normalized component form (no 1/2 exponent factor,
    1/(s1 s2 sqrt(1-r^2)) weights)."""
    consts = [np.asarray(v, np.float64) for v in (mixture, means, sigmas,
                                                  corr)]

    def potential(theta):
        w, mu, sd, r = (torch.as_tensor(v, dtype=theta.dtype,
                                        device=theta.device) for v in consts)
        x_ = (theta[..., 0, None] - mu[:, 0]) / sd[:, 0]
        y_ = (theta[..., 1, None] - mu[:, 1]) / sd[:, 1]
        comp = (w * torch.exp(-(x_**2 + y_**2 - 2 * r * x_ * y_)
                              / (2 * (1 - r**2)))
                / (sd[:, 0] * sd[:, 1] * torch.sqrt(1 - r**2)))
        return -torch.log(comp.sum(-1))

    return potential


def four_mixture_potential():
    """4-component mixture used in the reference grids."""
    return mixture_potential(
        mixture=(0.25, 0.25, 0.25, 0.25),
        means=((-2, -2), (-2, 2), (2, -2), (2, 2)),
        sigmas=((0.7, 0.7),) * 4,
        corr=(0.0, 0.0, 0.0, 0.0),
    )


def gaussian_grid_potential(n: int = 5, spacing: float = 2.0,
                            sigma: float = 0.3):
    """n x n grid of isotropic Gaussians (the reference's 5x5 grid toy)."""
    ax = (np.arange(n) - (n - 1) / 2.0) * spacing
    means = np.stack(np.meshgrid(ax, ax), axis=-1).reshape(-1, 2)
    k = means.shape[0]
    return mixture_potential(
        mixture=tuple([1.0 / k] * k),
        means=tuple(map(tuple, means)),
        sigmas=tuple([(sigma, sigma)] * k),
        corr=tuple([0.0] * k),
    )


TOY_POTENTIALS = {
    "banana": banana_potential,
    "gauss": gaussian_potential,
    "multimodal": mixture_potential,
    "four_mixture": four_mixture_potential,
    "gauss_grid": gaussian_grid_potential,
}
