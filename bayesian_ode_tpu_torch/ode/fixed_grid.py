"""Fixed-grid solvers (euler / midpoint / rk4 and the symplectic steppers
of `symplectic.py`) as a loop over the grid.

Counterpart of `bayesian_ode_tpu/ode/fixed_grid.py`.  The grid is the
output times, or with `step_size` a uniform grid from t[0] clamped to end
at t[-1], whose solution is then linearly interpolated onto the output
times.  Each step function returns the increment of y, so `compensated`
can carry the Kahan compensation of y += dy.  The state is a tree of
tensors (`utils/pytree.py`).  Time stays in its own dtype (float64 in
`odeint`) and is cast to each leaf's dtype for the step.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.pytree import tree_map
from .runge_kutta import rk4_alt_step
from .symplectic import SYMPLECTIC_STEP_FUNCS


def euler_step(func, t, dt, y):
    return tree_map(lambda f: dt.to(f.dtype) * f, func(t, y)), 1


def midpoint_step(func, t, dt, y):
    y_mid = tree_map(lambda y_, f: y_ + f * dt.to(f.dtype) / 2, y, func(t, y))
    return tree_map(lambda f: dt.to(f.dtype) * f, func(t + dt / 2, y_mid)), 2


def rk4_step_fn(func, t, dt, y):
    # the reference's RK4 is the 3/8-rule variant
    return rk4_alt_step(func, t, dt, y), 4


STEP_FUNCS = {
    "euler": euler_step,
    "midpoint": midpoint_step,
    "rk4": rk4_step_fn,
    **SYMPLECTIC_STEP_FUNCS,
}


def _build_grid(ts: torch.Tensor, step_size: float) -> torch.Tensor:
    """Uniform grid from t[0] with the given step, clamped to end at
    t[-1] (the JAX package's `_build_grid`)."""
    ts_host = ts.detach().cpu().numpy()
    t_start, t_end = float(ts_host[0]), float(ts_host[-1])
    niters = int(math.ceil((t_end - t_start) / step_size + 1))
    grid = np.arange(niters) * step_size + t_start
    if grid[-1] > t_end:
        grid[-1] = t_end
    return torch.as_tensor(grid, dtype=ts.dtype, device=ts.device)


def _linear_interp_onto(ts, grid, ys_grid):
    """Linearly interpolate the grid solution (a tree of (G, ...) leaves)
    onto `ts`."""
    idx = torch.clamp(torch.searchsorted(grid, ts, right=True) - 1, 0,
                      grid.shape[0] - 2)
    t0, t1 = grid[idx], grid[idx + 1]
    w = (ts - t0) / (t1 - t0)

    def leaf(y):
        y0, y1 = y[idx], y[idx + 1]
        wc = w.reshape(w.shape + (1,) * (y0.dim() - 1)).to(y0.dtype)
        return y0 + wc * (y1 - y0)

    return tree_map(leaf, ys_grid)


def integrate_fixed_grid(func: Callable, y0: torch.Tensor, ts: torch.Tensor,
                         method: str, step_size: Optional[float] = None,
                         compensated: bool = False):
    """Integrate on a fixed grid, returning (ys at `ts`, stats).

    `func(t, y)` takes a scalar time tensor.  stats are the JAX package's:
    nfe, n_accepted (grid steps), n_rejected (0), reached_final_time."""
    step = STEP_FUNCS[method]
    grid = ts if step_size is None else _build_grid(ts, step_size)
    y = y0
    comp = tree_map(torch.zeros_like, y0) if compensated else None
    ys, nfe = [y0], 0
    for i in range(grid.shape[0] - 1):
        t0, t1 = grid[i], grid[i + 1]
        dy, evals = step(func, t0, t1 - t0, y)
        if compensated:
            d_eff = tree_map(lambda d, c: d + c, dy, comp)
            y1 = tree_map(lambda a, d: a + d, y, d_eff)
            comp = tree_map(lambda d, s, a: d - (s - a), d_eff, y1, y)
        else:
            y1 = tree_map(lambda a, b: a + b, y, dy)
        y = y1
        ys.append(y)
        nfe += evals
    ys = tree_map(lambda *leaves: torch.stack(leaves), *ys)
    if step_size is not None:
        ys = _linear_interp_onto(ts, grid, ys)
    stats = {"nfe": nfe, "n_accepted": grid.shape[0] - 1, "n_rejected": 0,
             "reached_final_time": True}
    return ys, stats
