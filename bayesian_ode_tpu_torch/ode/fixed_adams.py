"""Fixed-grid Adams-Bashforth(-Moulton), orders up to 12, batched.

Counterpart of `bayesian_ode_tpu/ode/fixed_adams.py` ("explicit_adams"
and "fixed_adams"; reference torchdiffeq/_impl/fixed_adams.py).  Every
system of the batch keeps its own history ring buffer of past slopes
(leaves (width, B, ...), newest first) and its own order, which indexes
the zero-padded float64 Bashforth/Moulton tables by a per-system gather.

Semantics, as the JAX package's:
  - while a system's order is below 3 it steps by rk4's 3/8 rule (4 RHS
    evaluations, the first the history's new slope);
  - then an Adams-Bashforth predictor, and for "fixed_adams" an
    Adams-Moulton corrector by functional iteration, at most max_iters
    evaluations, each converged when every element of the system's
    increment moved by less than atol + rtol max(|old|, |new|);
  - a system whose corrector does not converge keeps the last iterate,
    counts a `corrector_fails`, and carries its order minus 1 (its oldest
    history entry drops), so the fill of the ring buffer differs between
    systems;
  - the history takes f at each step's start only.
The corrector's iterations run in masked lockstep, one host read of the
active mask an iteration (and one a step for the rk4 start).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..utils.pytree import tree_leaves, tree_map
from .fixed_grid import _build_grid, _linear_interp_onto
from .adaptive import _where
from .runge_kutta import _bcast, rk4_alt_step

_MAX_ORDER = 12
_MIN_ORDER = 4

# integer Adams coefficients for orders <= 12 (the classical tables)
_BASHFORTH = [
    [],
    [11],
    [3, -1],
    [23, -16, 5],
    [55, -59, 37, -9],
    [1901, -2774, 2616, -1274, 251],
    [4277, -7923, 9982, -7298, 2877, -475],
    [198721, -447288, 705549, -688256, 407139, -134472, 19087],
    [434241, -1152169, 2183877, -2664477, 2102243, -1041723, 295767, -36799],
    [14097247, -43125206, 95476786, -139855262, 137968480, -91172642,
     38833486, -9664106, 1070017],
    [30277247, -104995189, 265932680, -454661776, 538363838, -444772162,
     252618224, -94307320, 20884811, -2082753],
    [2132509567, -8271795124, 23591063805, -46113029016, 63716378958,
     -63176201472, 44857168434, -22329634920, 7417904451, -1479574348,
     134211265],
]

_MOULTON = [
    [],
    [1],
    [1, 1],
    [5, 8, -1],
    [9, 19, -5, 1],
    [251, 646, -264, 106, -19],
    [475, 1427, -798, 482, -173, 27],
    [19087, 65112, -46461, 37504, -20211, 6312, -863],
    [36799, 139849, -121797, 123133, -88547, 41499, -11351, 1375],
    [1070017, 4467094, -4604594, 5595358, -5033120, 3146338, -1291214,
     312874, -33953],
    [2082753, 9449717, -11271304, 16002320, -17283646, 13510082, -7394032,
     2687864, -583435, 57281],
    [134211265, 656185652, -890175549, 1446205080, -1823311566, 1710774528,
     -1170597042, 567450984, -184776195, 36284876, -3250433],
    [262747265, 1374799219, -2092490673, 3828828885, -5519460582,
     6043521486, -4963166514, 3007739418, -1305971115, 384709327,
     -68928781, 5675265],
]

_DIVISOR = [1, 11, 2, 12, 24, 720, 1440, 60480, 120960, 3628800, 7257600,
            479001600, 958003200]


def _padded_tables(max_order: int):
    """Dense float64 tables of coefficient/divisor ratios: Bashforth rows
    (max_order, width), and the Moulton rows split into the leading weight
    of the new slope (max_order + 1,) and the history's (max_order + 1,
    width)."""
    width = max_order - 1
    bash = np.zeros((max_order, width))
    for o in range(1, max_order):
        bash[o, :o] = np.asarray(_BASHFORTH[o], dtype=np.float64) / _DIVISOR[o]
    m0 = np.zeros((max_order + 1,))
    mrest = np.zeros((max_order + 1, width))
    for k in range(1, max_order + 1):
        row = np.asarray(_MOULTON[k], dtype=np.float64) / _DIVISOR[k]
        m0[k] = row[0]
        mrest[k, : k - 1] = row[1:]
    return bash, m0, mrest


def _weighted_history(weights, fbuf):
    """sum_i weights[:, i] * fbuf[i] per system: weights (B, width), fbuf
    leaves (width, B, ...)."""
    def leaf(f):
        w = weights.to(f.dtype).t().reshape(
            weights.shape[::-1] + (1,) * (f.dim() - 2))
        return (w * f).sum(dim=0)

    return tree_map(leaf, fbuf)


def _has_converged(old, new, rtol, atol):
    """(B,): every element of each system's increment moved by less than
    atol + rtol max(|old|, |new|)."""
    out = None
    for a, b in zip(tree_leaves(old), tree_leaves(new)):
        ok = (a - b).abs() < atol + rtol * torch.maximum(a.abs(), b.abs())
        ok = ok.reshape(ok.shape[0], -1).all(dim=1)
        out = ok if out is None else out & ok
    return out


def integrate_abm(func: Callable, y0, ts: torch.Tensor, rtol: float = 1e-3,
                  atol: float = 1e-4, implicit: bool = True,
                  max_iters: int = 4, max_order: int = _MAX_ORDER,
                  step_size: Optional[float] = None):
    """Integrate a batch y0 (leaves (B, ...)) on the grid ts (T,) (or a
    uniform `step_size` grid, linearly interpolated onto ts).  func(t (B,),
    y).  Returns (ys (T, B, ...), per-system stats with
    corrector_fails)."""
    max_order = int(min(max_order, _MAX_ORDER))
    width = max_order - 1
    leaves = tree_leaves(y0)
    B, dev = leaves[0].shape[0], leaves[0].device
    f64 = dict(dtype=torch.float64, device=dev)
    bash, m0, mrest = (torch.as_tensor(x, **f64)
                       for x in _padded_tables(max_order))
    grid = ts if step_size is None else _build_grid(ts, step_size)
    i64 = dict(dtype=torch.int64, device=dev)
    y = y0
    fbuf = tree_map(lambda l: torch.zeros((width,) + tuple(l.shape),
                                          dtype=l.dtype, device=dev), y0)
    count = torch.zeros(B, **i64)
    fails = torch.zeros(B, **i64)
    nfe = torch.zeros(B, **i64)
    ys = [y0]
    for i in range(grid.shape[0] - 1):
        t0, t1 = grid[i], grid[i + 1]
        dt = t1 - t0
        tb0, tb1 = t0.expand(B), t1.expand(B)
        fval = func(tb0, y)
        fbuf = tree_map(lambda buf, f: torch.cat([f[None], buf[:-1]]), fbuf,
                        fval)
        order = torch.clamp_max(count + 1, width)
        start = order < _MIN_ORDER - 1
        # Adams-Bashforth predictor of every system
        dy = tree_map(lambda inc: dt.to(inc.dtype) * inc,
                      _weighted_history(bash[order], fbuf))
        evals = torch.ones(B, **i64)
        converged = torch.ones(B, dtype=torch.bool, device=dev)
        if implicit:
            delta = tree_map(lambda inc: dt.to(inc.dtype) * inc,
                             _weighted_history(mrest[order + 1], fbuf))
            lead = m0[order + 1]
            converged = torch.zeros(B, dtype=torch.bool, device=dev)
            for _ in range(max_iters):
                active = ~converged & ~start
                if not bool(active.any()):
                    break
                f = func(tb1, tree_map(lambda a, b: a + b, y, dy))
                dy_new = tree_map(
                    lambda f_, d_: (_bcast(dt, f_) * _bcast(lead, f_)) * f_
                    + d_, f, delta)
                ok = _has_converged(dy, dy_new, rtol, atol)
                dy = _where(active, dy_new, dy)
                converged = torch.where(active, ok, converged)
                evals = evals + active.to(torch.int64)
            order = torch.where(converged | start, order, order - 1)
        if bool(start.any()):
            dy_rk = rk4_alt_step(func, tb0, dt.expand(B), y, k1=fval)
            dy = _where(start, dy_rk, dy)
            evals = torch.where(start, torch.full_like(evals, 4), evals)
        fails = fails + (~converged & ~start).to(torch.int64)
        y = tree_map(lambda a, b: a + b, y, dy)
        ys.append(y)
        count = order
        nfe = nfe + evals
    ys = tree_map(lambda *ls: torch.stack(ls), *ys)
    if step_size is not None:
        ys = _linear_interp_onto(ts, grid, ys)
    return ys, {"nfe": nfe,
                "n_accepted": torch.full((B,), grid.shape[0] - 1, **i64),
                "n_rejected": torch.zeros(B, **i64),
                "reached_final_time": torch.ones(B, dtype=torch.bool,
                                                 device=dev),
                "corrector_fails": fails}
