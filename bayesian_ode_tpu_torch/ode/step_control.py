"""Error norms and step-size control, batched over independent systems.

Counterpart of `bayesian_ode_tpu/ode/step_control.py`.  Every function takes
a leading batch axis B (one system per row, each with its own step size);
states are trees of tensors (`utils/pytree.py`) whose leaves all carry that
axis.  All data-dependent branching is `torch.where`, so a batch advances
in masked lockstep.
"""
from __future__ import annotations

import torch

from ..utils.pytree import tree_leaves


def _per_system_mean(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=1)


def error_ratio(y1_error, rtol, atol, y0, y1, ulp_floor: float = 32.0,
                norm_weights=None):
    """(B,) squared error ratio per system for accept/reject and step
    control.

    Per leaf: the mean over the system's elements of (err / tol)^2, with
    tol = atol + rtol * max(|y0|, |y1|) floored at `ulp_floor` ulps of the
    leaf's own dtype times the state magnitude (below that floor the error
    estimate is rounding noise of the stage combination, and resolving it
    would collapse the step size in float32: the JAX package measured
    ~170x NFE inflation at rtol=1e-7 without it).  The adaptive solvers
    pass 32 ulps, or 4 with the Kahan-compensated carry
    (AdaptiveConfig.compensated), which removes the accumulated rounding
    of the state itself.  Each leaf's ratio is
    scaled by its weight in `norm_weights` (a tree of Python floats shaped
    like the state; 0.0 removes a leaf from error control, as the adjoint
    seminorm does), and the ratio is the max over leaves.  A single-tensor
    state gives the reference's mean-square ratio.
    """
    errs, a, b = tree_leaves(y1_error), tree_leaves(y0), tree_leaves(y1)
    weights = ([None] * len(errs) if norm_weights is None
               else tree_leaves(norm_weights))
    out = None
    for e, y0_, y1_, w in zip(errs, a, b, weights):
        if e[0].numel() == 0:
            continue
        mag = torch.maximum(y0_.abs(), y1_.abs())
        tol = atol + rtol * mag
        ulps = ulp_floor * torch.finfo(e.dtype).eps
        tol = torch.maximum(tol, ulps * mag)
        r = _per_system_mean((e / tol) ** 2)
        if w is not None:
            r = r * w
        out = r if out is None else torch.maximum(out, r)
    return out


def optimal_step_size(last_step, ratio, safety=0.9, ifactor=10.0,
                      dfactor=0.2, order=5):
    """dt' = dt / clip(sqrt(r)^(1/order) / safety, 1/ifactor, 1/dfactor),
    with dfactor disabled when r < 1, and dt * ifactor when r == 0.
    `order` is a Python number or a (B,) tensor (the variable-order Adams
    method's per-system order)."""
    r = ratio.to(last_step.dtype)
    dfac = torch.where(r < 1.0, torch.ones_like(r), torch.full_like(r, dfactor))
    err = torch.sqrt(torch.clamp_min(r, torch.finfo(last_step.dtype).tiny))
    exponent = (1.0 / order.to(r.dtype) if torch.is_tensor(order)
                else 1.0 / order)
    factor = torch.maximum(
        torch.full_like(r, 1.0 / ifactor),
        torch.minimum(err ** exponent / safety, 1.0 / dfac),
    )
    return torch.where(r == 0.0, last_step * ifactor, last_step / factor)


def pi_step_size(last_step, ratio, err_prev, accept, safety=0.9,
                 ifactor=10.0, dfactor=0.2, order=5, beta1=0.6, beta2=-0.2):
    """Gustafsson/Soderlind PI step controller (PI.4.2 coefficients), per
    system.  Accepted steps use the two-error memory

        dt' = dt * clip(safety * err^(-beta1/q) * err_prev^(-beta2/q),
                        dfactor, ifactor),

    rejected steps the memoryless formula of `optimal_step_size` with
    dfactor in force; dt * ifactor when r == 0.  `err_prev` (B,) is the
    sqrt error ratio of each system's last accepted step (1 initially)."""
    r = ratio.to(last_step.dtype)
    tiny = torch.finfo(last_step.dtype).tiny
    q = order
    err = torch.sqrt(torch.clamp_min(r, tiny))
    ep = torch.clamp_min(err_prev.to(last_step.dtype), tiny)
    factor_acc = safety * err ** (-beta1 / q) * ep ** (-beta2 / q)
    dt_acc = last_step * torch.clamp(factor_acc, dfactor, ifactor)
    factor_rej = torch.maximum(
        torch.full_like(r, 1.0 / ifactor),
        torch.minimum(err ** (1.0 / q) / safety,
                      torch.full_like(r, 1.0 / dfactor)))
    dt = torch.where(accept, dt_acc, last_step / factor_rej)
    return torch.where(r == 0.0, last_step * ifactor, dt)


def _rms(tree) -> torch.Tensor:
    """(B,) RMS over all of each system's elements, across leaves:
    sqrt(sum of squares / element count), as the JAX package's
    `tree_rms_norm`.  Leaves of mixed dtypes sum in float64."""
    leaves = tree_leaves(tree)
    n = sum(x[0].numel() for x in leaves)
    ss = sum(x.reshape(x.shape[0], -1).pow(2).sum(dim=1).to(torch.float64)
             for x in leaves)
    return torch.sqrt(ss / n)


def select_initial_step(func, t0, y0, order, rtol, atol, f0):
    """Hairer, Norsett & Wanner II.4 initial step, per system (B,).

    Branch-free, as `bayesian_ode_tpu.ode.step_control.select_initial_step`,
    with the global RMS norms over the whole state tree (for the augmented
    adjoint state, whose a_t has zero initial slope).  Costs one extra RHS
    evaluation.
    """
    from ..utils.pytree import tree_map

    scale = tree_map(lambda y: atol + y.abs() * rtol, y0)
    d0 = _rms(tree_map(lambda y, s: y / s, y0, scale)).to(t0.dtype)
    d1 = _rms(tree_map(lambda f, s: f / s, f0, scale)).to(t0.dtype)
    tiny = torch.finfo(t0.dtype).tiny
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6),
                     0.01 * d0 / torch.clamp_min(d1, tiny))

    def step(y, f):
        return y + h0.to(y.dtype).reshape((-1,) + (1,) * (y.dim() - 1)) * f

    f1 = func(t0 + h0, tree_map(step, y0, f0))
    d2 = _rms(tree_map(lambda a, b, s: (a - b) / s, f1, f0, scale)).to(
        t0.dtype) / h0
    flat = (d1 <= 1e-15) & (d2 <= 1e-15)
    h1_flat = torch.clamp_min(h0 * 1e-3, 1e-6)
    h1_steep = (0.01 / torch.clamp_min(torch.maximum(d1, d2), tiny)) ** (
        1.0 / (order + 1.0))
    h1 = torch.where(flat, h1_flat, h1_steep)
    return torch.minimum(100 * h0, h1)
