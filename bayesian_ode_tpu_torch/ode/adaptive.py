"""Adaptive Runge-Kutta integration of a batch of independent systems.

Counterpart of `bayesian_ode_tpu/ode/adaptive.py`: the explicit dopri5 and
tsit5 pairs (quartic dense output and the Tsitouras interpolant), the
memoryless ("i") and PI controllers, the options of `AdaptiveConfig`, and
the public step API (`init_adaptive_state`, `adaptive_step`, `can_step`).

States are trees of tensors whose leaves carry a leading batch axis B.
Each system of the batch has its own step size and accept/reject
decisions, as the JAX package's vmap of its per-system while loop has:
the batch advances in masked lockstep (one host read of the active mask a
step), and each step emits every output time its system has crossed,
evaluated on the dense output of that system's last accepted step.  The
loop is plain torch, so autograd differentiates through it in every mode;
the JAX modes "while" and "while_scan" take the same steps, and "bounded"
(autograd through the step loop) is the same loop without the JAX
package's per-interval step cap.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..utils.pytree import tree_leaves, tree_map, tree_unflatten
from .interp import interp_evaluate, interp_fit
from .runge_kutta import (AdaptiveState, _bcast, runge_kutta_step,
                          weighted_stage_sum)
from .step_control import (error_ratio, optimal_step_size, pi_step_size,
                           select_initial_step)
from .tableaus import DOPRI5, ButcherTableau, tsit5_interp_coeffs

MODES = ("while", "while_scan", "bounded")


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    rtol: float = 1e-7
    atol: float = 1e-9
    first_step: Optional[float] = None
    safety: float = 0.9
    ifactor: float = 10.0
    dfactor: float = 0.2
    max_num_steps: int = 2**20
    mode: str = "while"
    ulp_floor: Optional[float] = None   # default 32 ulps
    # "i": the reference's memoryless controller; "pi": the Gustafsson /
    # Soderlind PI controller (step_control.pi_step_size)
    controller: str = "i"
    # per-leaf error-norm weights (Python floats in the state's tree
    # structure); 0.0 removes a leaf from error control
    norm_weights: Any = None

    def __post_init__(self):
        if self.controller not in ("i", "pi"):
            raise ValueError(
                f"unknown step controller {self.controller!r}; expected "
                "'i' (reference parity) or 'pi' (Gustafsson)")
        if self.mode not in MODES:
            raise ValueError(f"unknown adaptive mode: {self.mode!r}")


def _where(mask, new, old):
    """Leafwise where with a (B,) mask broadcast over trailing axes."""
    return tree_map(lambda a, b: torch.where(_bcast(mask, a).bool(), a, b),
                    new, old)


# ---------------------------------------------------------------------------
# Dense output.  quartic (dopri5): the 5 polynomial coefficient trees fit
# from (y0, y1, y_mid, f0, f1); stages (tsit5): the interval's (y0, k)
# evaluated with the Tsitouras b_i(theta).  Evaluated at all output times
# at once: t0, t1 (B,) and t (T, B).
# ---------------------------------------------------------------------------

def _quartic_init(y0, f0):
    z = tree_map(torch.zeros_like, y0)
    return [z, z, z, z, y0]


def _quartic_fit(tableau, y0, y1, k, dt):
    y_mid = tree_map(lambda y, inc: y + inc, y0,
                     weighted_stage_sum(dt, tableau.c_mid, k))
    fits = [interp_fit(a, b, m, f0, f1, _bcast(dt, a)) for a, b, m, f0, f1
            in zip(*(tree_leaves(x) for x in (y0, y1, y_mid, k[0], k[-1])))]
    return [tree_unflatten(y0, [f[i] for f in fits]) for i in range(5)]


def _times(x, like):
    """Per-system times x (..., B) shaped against a leaf `like` (B, ...)."""
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


def _quartic_eval(coeff, t0, t1, t):
    """The quartic of each system's last accepted step at the times t
    (T, B): a tree of (T, B, ...) leaves."""
    def leaf(*cs):
        return interp_evaluate([c.unsqueeze(0) for c in cs],
                               _times(t0[None], cs[0]),
                               _times(t1[None], cs[0]), _times(t, cs[0]))

    return tree_map(leaf, *coeff)


def _stages_init(y0, f0):
    z = tree_map(torch.zeros_like, y0)
    return (y0, [z] * 7)


def _stages_fit(tableau, y0, y1, k, dt):
    return (y0, list(k))


def _stages_eval(coeff, t0, t1, t):
    """The Tsitouras interpolant of each system's last accepted step at
    the times t (T, B)."""
    y0, k = coeff
    t0, t1 = t0[None], t1[None]
    dt = t1 - t0
    same = t1 == t0
    denom = torch.where(same, torch.ones_like(t1), t1 - t0)
    theta = torch.where(same, torch.zeros_like(t - t0), (t - t0) / denom)
    bs = tsit5_interp_coeffs(theta)

    def leaf(y, *ks):
        def sh(x):
            return _times(x, y).to(y.dtype)

        return y.unsqueeze(0) + sh(dt) * sum(
            sh(b) * k_.unsqueeze(0) for b, k_ in zip(bs, ks))

    return tree_map(leaf, y0, *k)


INTERP = {
    "quartic": (_quartic_init, _quartic_fit, _quartic_eval),
    "stages": (_stages_init, _stages_fit, _stages_eval),
}


def adaptive_step(func: Callable, state: AdaptiveState,
                  tableau: ButcherTableau, interp_kind: str,
                  cfg: AdaptiveConfig) -> AdaptiveState:
    """One accept/reject adaptive RK step of every system of the batch,
    from the end of its last accepted step (state.y1 at state.t1): accept
    advances t1 by dt, reject shrinks dt.  All branching is `where`, per
    system; the caller masks systems that have finished."""
    _, fit, _ = INTERP[interp_kind]
    y0, f0, t0, dt = state.y1, state.f1, state.t1, state.dt
    y1, f1, y1_error, k = runge_kutta_step(func, y0, f0, t0, dt, tableau)
    floor = 32.0 if cfg.ulp_floor is None else cfg.ulp_floor
    ratio = error_ratio(y1_error, cfg.rtol, cfg.atol, y0, y1, floor,
                        cfg.norm_weights)
    accept = ratio <= 1.0
    coeff = _where(accept, fit(tableau, y0, y1, k, dt), state.interp_coeff)
    if cfg.controller == "pi":
        dt_next = pi_step_size(dt, ratio, state.err_prev, accept, cfg.safety,
                               cfg.ifactor, cfg.dfactor, tableau.order)
        err = torch.sqrt(torch.clamp_min(
            ratio.to(dt.dtype), torch.finfo(dt.dtype).tiny))
        err_prev = torch.where(accept, err, state.err_prev)
    else:
        dt_next = optimal_step_size(dt, ratio, cfg.safety, cfg.ifactor,
                                    cfg.dfactor, tableau.order)
        err_prev = state.err_prev
    return AdaptiveState(
        y1=_where(accept, y1, y0), f1=_where(accept, f1, f0), t0=t0,
        t1=torch.where(accept, t0 + dt, t0), dt=dt_next, interp_coeff=coeff,
        nfe=state.nfe + len(tableau.alpha),
        n_accepted=state.n_accepted + accept.to(state.n_accepted.dtype),
        n_rejected=state.n_rejected + (~accept).to(state.n_rejected.dtype),
        comp=None, err_prev=err_prev)


def can_step(state: AdaptiveState) -> torch.Tensor:
    """(B,) divergence guard: once a system's error goes non-finite every
    step rejects and dt decays to NaN or 0; such a system stops (with
    reached_final_time False), as on an exhausted budget."""
    return torch.isfinite(state.dt) & (state.dt > 0)


def init_adaptive_state(func: Callable, y0, t0, tableau: ButcherTableau,
                        interp_kind: str,
                        cfg: AdaptiveConfig) -> AdaptiveState:
    """The `AdaptiveState` at t0 ((B,) or a scalar, in the time dtype) of a
    batch y0: f0 = f(t0, y0) and the Hairer start step (nfe 2), or
    cfg.first_step (nfe 1)."""
    init_interp, _, _ = INTERP[interp_kind]
    B = tree_leaves(y0)[0].shape[0]
    dev = tree_leaves(y0)[0].device
    t0 = torch.as_tensor(t0, device=dev)
    t0 = t0.expand(B).clone() if t0.dim() == 0 else t0
    f0 = func(t0, y0)
    if cfg.first_step is None:
        dt0 = select_initial_step(func, t0, y0, tableau.order - 1, cfg.rtol,
                                  cfg.atol, f0)
        nfe0 = 2
    else:
        dt0 = torch.full_like(t0, cfg.first_step)
        nfe0 = 1
    i64 = dict(dtype=torch.int64, device=dev)
    return AdaptiveState(
        y1=y0, f1=f0, t0=t0, t1=t0.clone(), dt=dt0,
        interp_coeff=init_interp(y0, f0),
        nfe=torch.full((B,), nfe0, **i64), n_accepted=torch.zeros(B, **i64),
        n_rejected=torch.zeros(B, **i64), comp=None,
        err_prev=(torch.ones_like(dt0) if cfg.controller == "pi" else None))


def integrate_adaptive(func: Callable, y0, ts: torch.Tensor,
                       cfg: AdaptiveConfig, tableau: ButcherTableau = DOPRI5,
                       interp_kind: str = "quartic"):
    """Integrate y' = func(t, y) for a batch y0 (a tree of (B, ...) leaves)
    at the times ts (T,), increasing.

    func(t (B,), y) -> a tree shaped like y.  Returns (ys, stats): ys a
    tree of (T, B, ...) leaves with ys[0] == y0, stats the per-system
    nfe / n_accepted / n_rejected / reached_final_time.
    """
    _, _, evaluate = INTERP[interp_kind]
    leaves = tree_leaves(y0)
    B, T, dev = leaves[0].shape[0], ts.shape[0], leaves[0].device
    state = init_adaptive_state(func, y0, ts[0], tableau, interp_kind, cfg)

    def buffer(leaf):
        out = torch.zeros((T,) + tuple(leaf.shape), dtype=leaf.dtype,
                          device=dev)
        out[0] = leaf
        return out

    ys = tree_map(buffer, y0)
    done = torch.zeros((T, B), dtype=torch.bool, device=dev)
    done[0] = True
    while True:
        active = ((~done).any(dim=0)
                  & (state.n_accepted + state.n_rejected < cfg.max_num_steps)
                  & can_step(state))
        if not bool(active.any()):
            break
        new = adaptive_step(func, state, tableau, interp_kind, cfg)
        state = AdaptiveState(
            y1=_where(active, new.y1, state.y1),
            f1=_where(active, new.f1, state.f1),
            t0=torch.where(active, new.t0, state.t0),
            t1=torch.where(active, new.t1, state.t1),
            dt=torch.where(active, new.dt, state.dt),
            interp_coeff=_where(active, new.interp_coeff,
                                state.interp_coeff),
            nfe=torch.where(active, new.nfe, state.nfe),
            n_accepted=torch.where(active, new.n_accepted,
                                   state.n_accepted),
            n_rejected=torch.where(active, new.n_rejected,
                                   state.n_rejected),
            err_prev=(None if new.err_prev is None else
                      torch.where(active, new.err_prev, state.err_prev)))
        emit = (~done) & (ts[:, None] <= state.t1[None, :]) & active[None, :]
        if bool(emit.any()):
            vals = evaluate(state.interp_coeff, state.t0, state.t1,
                            ts[:, None].expand(T, B))
            ys = tree_map(lambda o, v: torch.where(
                emit.reshape(emit.shape + (1,) * (o.dim() - 2)), v, o),
                ys, vals)
            done = done | emit
    stats = {"nfe": state.nfe, "n_accepted": state.n_accepted,
             "n_rejected": state.n_rejected,
             "reached_final_time": state.t1 >= ts[-1]}
    return ys, stats
