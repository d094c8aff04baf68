"""Adaptive dopri5 integration of a batch of independent systems.

Counterpart of `bayesian_ode_tpu/ode/adaptive.py` reduced to what the
main-path slice needs: the explicit dopri5 pair with quartic dense output,
the memoryless ("i") controller and the single-loop ("while") emission
order, forward only.  Each system of the batch has its own step size and
accept/reject decisions; the batch advances in masked lockstep, and each
step emits every output time its system has crossed, evaluated on the
quartic of that system's last accepted step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .interp import interp_evaluate, interp_fit
from .runge_kutta import _bcast, runge_kutta_step, weighted_stage_sum
from .step_control import error_ratio, optimal_step_size, select_initial_step
from .tableaus import DOPRI5


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    rtol: float = 1e-7
    atol: float = 1e-9
    safety: float = 0.9
    ifactor: float = 10.0
    dfactor: float = 0.2
    max_num_steps: int = 2**20
    ulp_floor: float = 32.0


def integrate_adaptive(func: Callable, y0: torch.Tensor, ts: torch.Tensor,
                       cfg: AdaptiveConfig):
    """Integrate y' = func(t, y) for a batch y0 (B, ...) at the times ts (T,).

    func(t (B,), y (B, ...)) -> (B, ...).  Returns (ys (T, B, ...), stats)
    with ys[0] == y0 and per-system nfe / n_accepted / n_rejected /
    reached_final_time.
    """
    tableau = DOPRI5
    B, T = y0.shape[0], ts.shape[0]
    dev = y0.device
    t0 = ts[0].expand(B).clone()
    f0 = func(t0, y0)
    dt = select_initial_step(func, t0, y0, tableau.order - 1, cfg.rtol,
                             cfg.atol, f0)
    y, f, t_start, t1 = y0, f0, t0.clone(), t0.clone()
    zero = torch.zeros_like(y0)
    coeff = [zero, zero, zero, zero, y0]
    nfe = torch.full((B,), 2, dtype=torch.int64, device=dev)
    n_acc = torch.zeros(B, dtype=torch.int64, device=dev)
    n_rej = torch.zeros(B, dtype=torch.int64, device=dev)
    ys = torch.zeros((T,) + tuple(y0.shape), dtype=y0.dtype, device=dev)
    ys[0] = y0
    done = torch.zeros((T, B), dtype=torch.bool, device=dev)
    done[0] = True

    while True:
        active = ((~done).any(dim=0)
                  & (n_acc + n_rej < cfg.max_num_steps)
                  & torch.isfinite(dt) & (dt > 0))
        if not bool(active.any()):
            break
        y1, f1, err, k = runge_kutta_step(func, y, f, t1, dt, tableau)
        ratio = error_ratio(err, cfg.rtol, cfg.atol, y, y1, cfg.ulp_floor)
        accept = ratio <= 1.0
        take = active & accept
        y_mid = y + weighted_stage_sum(dt, tableau.c_mid, k)
        new_coeff = interp_fit(y, y1, y_mid, k[0], k[-1], _bcast(dt, y))
        sel = _bcast(take, y).bool()
        coeff = [torch.where(sel, n, o) for n, o in zip(new_coeff, coeff)]
        y = torch.where(sel, y1, y)
        f = torch.where(sel, f1, f)
        t_start = torch.where(take, t1, t_start)
        t1 = torch.where(take, t1 + dt, t1)
        dt_next = optimal_step_size(dt, ratio, cfg.safety, cfg.ifactor,
                                    cfg.dfactor, tableau.order)
        dt = torch.where(active, dt_next, dt)
        nfe = nfe + 6 * active
        n_acc = n_acc + take
        n_rej = n_rej + (active & ~accept)

        emit = (~done) & (ts[:, None] <= t1[None, :]) & active[None, :]
        if bool(emit.any()):
            view = (T, B) + (1,) * (y0.dim() - 1)
            vals = interp_evaluate(
                [c.unsqueeze(0) for c in coeff],
                t_start.reshape(view[1:]).unsqueeze(0),
                t1.reshape(view[1:]).unsqueeze(0),
                ts.reshape((T,) + (1,) * y0.dim()))
            ys = torch.where(emit.reshape(view), vals, ys)
            done = done | emit

    stats = {"nfe": nfe, "n_accepted": n_acc, "n_rejected": n_rej,
             "reached_final_time": t1 >= ts[-1]}
    return ys, stats
