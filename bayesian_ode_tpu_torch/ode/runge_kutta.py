"""One explicit Runge-Kutta step over a Butcher tableau, batched.

Counterpart of `bayesian_ode_tpu/ode/runge_kutta.py`: the embedded pairs
(FSAL or not, with DOP853's second error row) and the fixed-grid RK4
steps.  States are trees of tensors
(`utils/pytree.py`) whose leaves carry a leading batch axis; `t0` and `dt`
are (B,) in the time dtype and are cast to each leaf's dtype for the stage
arithmetic, as the JAX package does.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple

import torch

from ..utils.pytree import tree_map
from .tableaus import ButcherTableau


class AdaptiveState(NamedTuple):
    """Carry of the adaptive stepping loop, per system of the batch.

    y1:           state at the end of the last accepted step (a tree).
    f1:           the RHS there (FSAL).
    t0, t1:       (B,) endpoints of the last accepted step.
    dt:           (B,) proposed size of the next step.
    interp_coeff: dense output of [t0, t1]: the quartic's 5 coefficient
                  trees (dopri5), or (y0, the 7 stage trees) (tsit5).
    nfe, n_accepted, n_rejected: (B,) counters.
    comp:         Kahan compensation tree (the low bits lost when the step
                  increment was added to y1); None unless
                  AdaptiveConfig.compensated.
    err_prev:     (B,) sqrt error ratio of the last accepted step (the PI
                  controller's memory); None under the "i" controller.
    """
    y1: Any
    f1: Any
    t0: torch.Tensor
    t1: torch.Tensor
    dt: torch.Tensor
    interp_coeff: Any
    nfe: torch.Tensor
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor
    comp: Any = None
    err_prev: torch.Tensor = None


def _bcast(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> like's dtype, shaped (B, 1, ...) against `like`; a 0-d x is
    cast only."""
    x = x.to(like.dtype)
    if x.dim() == 0:
        return x
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


def _mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (B,) bool mask shaped (B, 1, ...) against `like`, as a view."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def weighted_stage_sum(dt, weights, k: List[Any]):
    """dt * sum_i weights[i] * k[i] over stage trees, skipping zero
    weights."""
    return tree_map(
        lambda *ks: _bcast(dt, ks[0])
        * sum(w * k_ for w, k_ in zip(weights, ks) if w != 0), *k)


def runge_kutta_step(func: Callable, y0, f0, t0, dt,
                     tableau: ButcherTableau):
    """Returns (y1, f1, y1_error, y1_error_alt, k), k the stage derivatives
    with f(t1, y1) last.  y1_error_alt is the second error estimate of a
    composite tableau (DOPRI8), else None.  A non-FSAL tableau combines y1
    from c_sol and evaluates f(t1, y1) fresh (tableau.nfe_per_step counts
    it); the error combination zips c_error against the s + 1 stages, so
    that extra slope never enters it."""
    k = [f0]
    yi = y0
    for alpha_i, beta_i in zip(tableau.alpha, tableau.beta):
        yi = tree_map(
            lambda y, *ks: y + _bcast(dt, y)
            * sum(b * k_ for b, k_ in zip(beta_i, ks) if b != 0), y0, *k)
        k.append(func(t0 + alpha_i * dt, yi))
    y1_error = weighted_stage_sum(dt, tableau.c_error, k)
    y1_error_alt = (None if tableau.c_error_alt is None
                    else weighted_stage_sum(dt, tableau.c_error_alt, k))
    if tableau.is_fsal:
        y1 = yi
    else:
        y1 = tree_map(
            lambda y, *ks: y + _bcast(dt, y)
            * sum(c * k_ for c, k_ in zip(tableau.c_sol, ks) if c != 0),
            y0, *k)
        k.append(func(t0 + dt, y1))
    return y1, k[-1], y1_error, y1_error_alt, k


def rk4_step(func: Callable, t, dt, y, k1=None):
    """Classic RK4 increment dt * (k1 + 2 k2 + 2 k3 + k4) / 6."""
    if k1 is None:
        k1 = func(t, y)
    k2 = func(t + dt / 2, tree_map(lambda y_, k_: y_ + _bcast(dt, y_) * k_ / 2,
                                   y, k1))
    k3 = func(t + dt / 2, tree_map(lambda y_, k_: y_ + _bcast(dt, y_) * k_ / 2,
                                   y, k2))
    k4 = func(t + dt, tree_map(lambda y_, k_: y_ + _bcast(dt, y_) * k_, y, k3))
    return tree_map(lambda a, b, c, d: (a + 2 * b + 2 * c + d)
                    * (_bcast(dt, a) / 6), k1, k2, k3, k4)


def rk4_alt_step(func: Callable, t, dt, y, k1=None):
    """Increment of one 3/8-rule RK4 step (the reference's fixed-grid
    RK4), in the operation order of the JAX package's `rk4_alt_step`.
    `t` and `dt` are in the time dtype; dt is cast to each leaf's dtype
    for the stage arithmetic."""
    if k1 is None:
        k1 = func(t, y)
    k2 = func(t + dt / 3, tree_map(lambda y_, a: y_ + _bcast(dt, y_) * a / 3,
                                   y, k1))
    k3 = func(t + dt * 2 / 3,
              tree_map(lambda y_, a, b: y_ + _bcast(dt, y_) * (-a / 3 + b),
                       y, k1, k2))
    k4 = func(t + dt, tree_map(lambda y_, a, b, c: y_ + _bcast(dt, y_)
                               * (a - b + c), y, k1, k2, k3))
    return tree_map(lambda a, b, c, d: (a + 3 * b + 3 * c + d)
                    * (_bcast(dt, a) / 8), k1, k2, k3, k4)
