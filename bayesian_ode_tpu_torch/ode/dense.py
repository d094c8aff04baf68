"""Dense-output integration: `odeint_dense` and `DenseSolution`, batched.

Counterpart of `bayesian_ode_tpu/ode/dense.py` (diffrax's
SaveAt(dense=True) / sol.evaluate): solve over [t0, t1] once and
evaluate y(t) at any time of the span from the solver's own per-step
dense outputs.  The adaptive step loop records each system's accepted
step ends and interpolation coefficients into preallocated buffers of
capacity options={"dense_steps": N} (default 512): times (B, N + 1),
coefficient leaves (N, B, ...), so a buffer holds N x B x the state size
x the number of coefficient trees of its kind (5 quartic, 8 Tsitouras,
4 Hermite, 8 DOP853).  Evaluation is a batched `torch.searchsorted`
over each system's own mesh and one dense-output evaluation.

A system that needs more accepted steps than the capacity stops there:
stats["reached_final_time"] is False and evaluation past its reached
time extends the last recorded step.  Decreasing spans integrate
backwards and are queried in user time; complex states are recorded
view-as-real and evaluated back to complex.  Gradients flow to the query
times and, under autograd, through the recorded solve.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..utils.pytree import tree_leaves, tree_map
from .adaptive import INTERP, can_step, init_adaptive_state, select_state
from .events import method_triple
from .odeint import (ADAPTIVE_OPTION_KEYS, adaptive_config,
                     complex_to_real, unbatch)


class DenseSolution:
    """The continuous solution over [t0, t1]; call it like a function.

    ts: (B, N + 1) canonical (increasing) step ends, coeffs: the
    coefficient trees with leaves (N, B, ...), n_steps (B,) recorded
    steps, sign: +1 or -1 from user to canonical time.  sol(t) takes a
    scalar or a tensor of user times and returns the state tree with the
    query shape as leading axes, then the batch axis when batched."""

    def __init__(self, ts, coeffs, n_steps, sign, stats, interp_kind,
                 batched, unpack):
        self.ts = ts
        self.coeffs = coeffs
        self.n_steps = n_steps
        self.sign = sign
        self.stats = stats
        self.interp_kind = interp_kind
        self.batched = batched
        self._unpack = unpack

    def _per_system(self, x):
        return x if self.batched else x[0]

    @property
    def t0(self):
        return self._per_system(self.sign * self.ts[:, 0])

    @property
    def t1(self):
        """The last time reached (the end of the span where
        stats['reached_final_time'])."""
        n = torch.clamp_max(self.n_steps, self.ts.shape[1] - 1)
        return self._per_system(self.sign * self.ts.gather(1, n[:, None])[:, 0])

    def __call__(self, t):
        ts, n_cap = self.ts, self.ts.shape[1] - 1
        B = ts.shape[0]
        t = torch.as_tensor(t, dtype=ts.dtype, device=ts.device)
        shape = tuple(t.shape)
        s = (self.sign * t).reshape(-1)                     # (Q,)
        Q = s.shape[0]
        n = torch.clamp_max(self.n_steps, n_cap)             # (B,)
        pos = torch.arange(n_cap + 1, device=ts.device)
        masked = torch.where(pos[None] <= n[:, None], ts,
                             torch.full_like(ts, float("inf")))
        idx = torch.searchsorted(masked, s[None].expand(B, Q).contiguous(),
                                 right=True) - 1
        idx = torch.minimum(torch.clamp_min(idx, 0),
                            torch.clamp_min(n - 1, 0)[:, None])  # (B, Q)
        t0 = masked.gather(1, idx).t().reshape(-1)          # (Q B,)
        t1 = masked.gather(1, idx + 1).t().reshape(-1)
        rows = idx.t().reshape(-1)
        cols = torch.arange(B, device=ts.device).repeat(Q)
        coeff = tree_map(lambda c: c[rows, cols], self.coeffs)
        _, _, evaluate = INTERP[self.interp_kind]
        tq = s[:, None].expand(Q, B).reshape(1, -1)
        y = tree_map(lambda v: v[0], evaluate(coeff, t0, t1, tq))
        y = tree_map(lambda v: v.reshape((Q, B) + tuple(v.shape[1:])), y)
        y = tree_map(lambda v: v.reshape(shape + tuple(
            v.shape[1:] if self.batched else v.shape[2:])), y)
        return self._unpack(y)

    evaluate = __call__


def odeint_dense(func: Callable, y0, t0, t1, rtol: float = 1e-7,
                 atol: float = 1e-9, method: str = "dopri5",
                 options: Optional[Dict[str, Any]] = None,
                 batched: bool = False):
    """Solve over [t0, t1] and return (DenseSolution, stats).  `method` is
    an adaptive method with dense output (those of `odeint_event`);
    `options` takes the adaptive options, `interp`, `reverse` and
    `dense_steps` (the capacity, default 512)."""
    options = dict(options or {})
    capacity = int(options.pop("dense_steps", 512))
    tableau, interp_kind, step_impl = method_triple(method)
    interp_kind = options.pop("interp", interp_kind)
    reverse = options.pop("reverse", None)
    unknown = set(options) - set(ADAPTIVE_OPTION_KEYS)
    if unknown:
        raise ValueError(f"unknown odeint_dense options: {sorted(unknown)}")
    cfg = adaptive_config(rtol, atol, options)
    func, y0, unpack = complex_to_real(func, y0)
    if not batched:
        func, y0 = unbatch(func, y0)
    leaves = tree_leaves(y0)
    B, dev = leaves[0].shape[0], leaves[0].device
    span = torch.stack([torch.as_tensor(t0, dtype=torch.float64),
                        torch.as_tensor(t1, dtype=torch.float64)]).to(dev)
    if reverse is None:
        reverse = bool(span[1] < span[0])
    sign = -1.0 if reverse else 1.0
    if reverse:
        base = func
        func = lambda s, y: tree_map(torch.neg, base(-s, y))  # noqa: E731
    s0, s1 = sign * span[0], sign * span[1]

    state = init_adaptive_state(func, y0, s0, tableau, interp_kind, cfg)
    ar = torch.arange(B, device=dev)
    ts_buf = s0.expand(B, capacity + 1).clone()
    # slot 0 holds the initial interpolant (y0 at any theta), so a solve of
    # no steps still evaluates
    coeff_buf = tree_map(lambda c: torch.cat(
        [c[None], torch.zeros((capacity - 1,) + tuple(c.shape),
                              dtype=c.dtype, device=dev)]),
        state.interp_coeff)
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    while True:
        active = ((state.t1 < s1) & (k < capacity)
                  & (state.n_accepted + state.n_rejected < cfg.max_num_steps)
                  & can_step(state))
        if not bool(active.any()):
            break
        new = select_state(active, step_impl(func, state, tableau,
                                             interp_kind, cfg), state)
        accepted = new.n_accepted > state.n_accepted
        state = new
        slot = torch.clamp_max(k, capacity - 1)
        ts_buf = ts_buf.index_put(
            (ar, slot + 1), torch.where(accepted, state.t1,
                                        ts_buf[ar, slot + 1]))

        def write(buf, c):
            keep = buf[slot, ar]
            return buf.index_put((slot, ar), torch.where(
                accepted.reshape((-1,) + (1,) * (c.dim() - 1)), c, keep))

        coeff_buf = tree_map(write, coeff_buf, state.interp_coeff)
        k = k + accepted.to(k.dtype)
    stats = {"nfe": state.nfe, "n_accepted": state.n_accepted,
             "n_rejected": state.n_rejected,
             "reached_final_time": state.t1 >= s1}
    sol = DenseSolution(ts_buf, coeff_buf, k, sign, stats, interp_kind,
                        batched, unpack)
    if not batched:
        stats = {key: v[0] for key, v in stats.items()}
        sol.stats = stats
    return sol, stats
