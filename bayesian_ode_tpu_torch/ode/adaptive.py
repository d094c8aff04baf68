"""Adaptive Runge-Kutta integration of a batch of independent systems.

Counterpart of `bayesian_ode_tpu/ode/adaptive.py`: the explicit pairs and
their dense outputs (the quartic of dopri5, the Tsitouras interpolant,
cubic Hermite for the low-order pairs and the implicit methods, DOP853's
7th-order output with its 3 extra RHS evaluations a step), the
memoryless ("i") and PI controllers, the Kahan-compensated carry, the
options of `AdaptiveConfig`, and the public step API
(`init_adaptive_state`, `adaptive_step`, `can_step`); `step_impl` swaps
the step for the implicit one of `ode/dirk.py`.

States are trees of tensors whose leaves carry a leading batch axis B.
Each system of the batch has its own step size and accept/reject
decisions, as the JAX package's vmap of its per-system while loop has:
the batch advances in masked lockstep (one host read of the active mask a
step), and each step emits every output time its system has crossed,
evaluated on the dense output of that system's last accepted step.
Output times are shared (T,) or per system (T, B).  The loop is plain
torch, so autograd differentiates through it in every mode; the JAX
modes "while" and "while_scan" take the same steps, and "bounded" steps
interval by interval, each system at most `max_steps_per_interval` times
an interval: a system that hits the cap stops short of the output time
and its output is its last step's dense output there, as in the JAX
package's bounded scan.  Without autograd, on a CUDA stream other than
the default one, the "while" loop of the explicit pairs replays each step
as one CUDA graph (`_while_in_place`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..utils.pytree import tree_leaves, tree_map, tree_unflatten
from .cuda_graph import GraphedStep, graphable
from .interp import interp_evaluate, interp_fit
from .runge_kutta import (AdaptiveState, _bcast, _mask, runge_kutta_step,
                          weighted_stage_sum)
from .step_control import (error_ratio, optimal_step_size, pi_step_size,
                           select_initial_step)
from .tableaus import DOPRI5, DOPRI8_DENSE, ButcherTableau, \
    tsit5_interp_coeffs

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
    max_steps_per_interval: int = 256   # "bounded" only
    # Kahan-compensated carry of y1 += dy: the low bits lost at each commit
    # are re-injected into the next, and the ulp floor drops to 4
    compensated: bool = False
    ulp_floor: Optional[float] = None   # default 32 ulps (4 compensated)
    # "i": the reference's memoryless controller; "pi": the Gustafsson /
    # Soderlind PI controller (step_control.pi_step_size)
    controller: str = "i"
    # the implicit methods only (ode/dirk.py): simplified-Newton
    # iterations a stage, its convergence threshold, and the embedded
    # error's treatment ("raw" or Shampine's M^-1 filter "shampine")
    newton_iters: int = 6
    newton_kappa: float = 0.1
    error_filter: str = "raw"
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

    @property
    def floor(self) -> float:
        if self.ulp_floor is not None:
            return self.ulp_floor
        return 4.0 if self.compensated else 32.0


def _where(mask, new, old):
    """Leafwise where with a (B,) mask broadcast over trailing axes."""
    return tree_map(lambda a, b: torch.where(_mask(mask, a), a, b),
                    new, old)


def _times(x, like):
    """Per-system times x (..., B) shaped against a leaf `like` (B, ...)."""
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


def _theta(t0, t1, t):
    """(t - t0) / (t1 - t0) at the times t (T, B) of each system's step
    [t0, t1] (B,), in the time dtype; a zero-length step gives 0 with the
    division guarded."""
    t0, t1 = t0[None], t1[None]
    same = t1 == t0
    denom = torch.where(same, torch.ones_like(t1), t1 - t0)
    return torch.where(same, torch.zeros_like(t - t0), (t - t0) / denom)


# ---------------------------------------------------------------------------
# Dense output, per kind: init(y0, f0), fit(func, tableau, y0, y1, k, t0,
# dt) and eval(coeff, t0, t1, t) at all output times at once: t0, t1 (B,),
# t (T, B), a tree of (T, B, ...) leaves back.
#   quartic (dopri5): the 5 coefficient trees fit from (y0, y1, y_mid, f0,
#     f1);
#   stages (tsit5): the interval's (y0, k) with the Tsitouras b_i(theta);
#   hermite (bosh3, fehlberg2, adaptive_heun, the DIRKs): cubic Hermite
#     from (y0, y1, dt f0, dt f1);
#   dop853 (dopri8): Hairer's CONTD8, 3 more stages and 7 coefficient
#     trees, evaluated by the alternating Horner recurrence.
# ---------------------------------------------------------------------------

def _quartic_init(y0, f0):
    z = tree_map(torch.zeros_like, y0)
    return [z, z, z, z, y0]


def _quartic_fit(func, tableau, y0, y1, k, t0, dt):
    y_mid = tree_map(lambda y, inc: y + inc, y0,
                     weighted_stage_sum(dt, tableau.c_mid, k))
    fits = [interp_fit(a, b, m, f0, f1, _bcast(dt, a)) for a, b, m, f0, f1
            in zip(*(tree_leaves(x) for x in (y0, y1, y_mid, k[0], k[-1])))]
    return [tree_unflatten(y0, [f[i] for f in fits]) for i in range(5)]


def _quartic_eval(coeff, t0, t1, t):
    def leaf(*cs):
        return interp_evaluate([c.unsqueeze(0) for c in cs],
                               _times(t0[None], cs[0]),
                               _times(t1[None], cs[0]), _times(t, cs[0]))

    return tree_map(leaf, *coeff)


def _stages_init(y0, f0):
    z = tree_map(torch.zeros_like, y0)
    return (y0, [z] * 7)


def _stages_fit(func, tableau, y0, y1, k, t0, dt):
    return (y0, list(k))


def _stages_eval(coeff, t0, t1, t):
    y0, k = coeff
    dt = (t1 - t0)[None]
    bs = tsit5_interp_coeffs(_theta(t0, t1, t))

    def leaf(y, *ks):
        def sh(x):
            return _times(x, y).to(y.dtype)

        return y.unsqueeze(0) + sh(dt) * sum(
            sh(b) * k_.unsqueeze(0) for b, k_ in zip(bs, ks))

    return tree_map(leaf, y0, *k)


def _hermite_init(y0, f0):
    z = tree_map(torch.zeros_like, y0)
    return (y0, y0, z, z)


def _hermite_fit(func, tableau, y0, y1, k, t0, dt):
    # k[0] and k[-1] are the endpoint slopes (the DIRKs pass (f0, f1))
    return (y0, y1, tree_map(lambda f: _bcast(dt, f) * f, k[0]),
            tree_map(lambda f: _bcast(dt, f) * f, k[-1]))


def _hermite_eval(coeff, t0, t1, t):
    th = _theta(t0, t1, t)
    h00 = (1 + 2 * th) * (1 - th) ** 2
    h10 = th * (1 - th) ** 2
    h01 = th ** 2 * (3 - 2 * th)
    h11 = th ** 2 * (th - 1)

    def leaf(a, b, da, db):
        def sh(x):
            return _times(x, a).to(a.dtype)

        return (sh(h00) * a.unsqueeze(0) + sh(h10) * da.unsqueeze(0)
                + sh(h01) * b.unsqueeze(0) + sh(h11) * db.unsqueeze(0))

    return tree_map(leaf, *coeff)


def _dop853_init(y0, f0):
    z = tree_map(torch.zeros_like, y0)
    return (y0, [z] * 7)


def _dop853_fit(func, tableau, y0, y1, k, t0, dt):
    """Hairer's 7th-order dense output of DOP853 (dop853.f CONTD8): three
    more stages at c = 0.1, 0.2 and 7/9 of the step (3 RHS evaluations an
    attempted step, counted in the step's NFE), then seven coefficient
    trees: three from the endpoint values and slopes, four from the D
    matrix over all 16 stages."""
    ks = list(k)
    for a_row, c in zip(DOPRI8_DENSE["a_extra"], DOPRI8_DENSE["c_extra"]):
        yi = tree_map(
            lambda y, *kk: y + _bcast(dt, y)
            * sum(a * k_ for a, k_ in zip(a_row, kk) if a != 0), y0, *ks)
        ks.append(func(t0 + c * dt, yi))
    f_old, f_new = ks[0], ks[12]
    delta = tree_map(lambda a, b: b - a, y0, y1)
    coeffs = [
        delta,
        tree_map(lambda f, d: _bcast(dt, f) * f - d, f_old, delta),
        tree_map(lambda d, fo, fn: 2 * d - _bcast(dt, d) * (fn + fo),
                 delta, f_old, f_new),
    ]
    for d_row in DOPRI8_DENSE["d"]:
        coeffs.append(tree_map(
            lambda *kk: _bcast(dt, kk[0])
            * sum(dv * k_ for dv, k_ in zip(d_row, kk) if dv != 0), *ks))
    return (y0, coeffs)


def _dop853_eval(coeff, t0, t1, t):
    y0, F = coeff
    x = _theta(t0, t1, t)

    def leaf(y, *fs):
        xx = _times(x, y).to(y.dtype)
        acc = fs[6].unsqueeze(0)
        for i, f in enumerate((fs[5], fs[4], fs[3], fs[2], fs[1], fs[0])):
            acc = f.unsqueeze(0) + acc * (xx if i % 2 == 0 else 1 - xx)
        return y.unsqueeze(0) + acc * xx

    return tree_map(leaf, y0, *F)


INTERP = {
    "quartic": (_quartic_init, _quartic_fit, _quartic_eval),
    "stages": (_stages_init, _stages_fit, _stages_eval),
    "hermite": (_hermite_init, _hermite_fit, _hermite_eval),
    "dop853": (_dop853_init, _dop853_fit, _dop853_eval),
}
# RHS evaluations a dense-output fit spends an attempted step
INTERP_NFE = {"quartic": 0, "stages": 0, "hermite": 0, "dop853": 3}


def evaluate_at(interp_kind: str, coeff, t0, t1, t):
    """The dense output of each system's step [t0, t1] at its own time
    t (B,): a tree of (B, ...) leaves."""
    _, _, evaluate = INTERP[interp_kind]
    return tree_map(lambda x: x[0], evaluate(coeff, t0, t1, t[None]))


def next_dt(dt, ratio, state, accept, cfg, order):
    """(dt of the next attempt, the PI controller's memory) after a step
    of error ratio `ratio`."""
    if cfg.controller == "pi":
        dt_next = pi_step_size(dt, ratio, state.err_prev, accept, cfg.safety,
                               cfg.ifactor, cfg.dfactor, order)
        err = torch.sqrt(torch.clamp_min(
            ratio.to(dt.dtype), torch.finfo(dt.dtype).tiny))
        return dt_next, torch.where(accept, err, state.err_prev)
    return (optimal_step_size(dt, ratio, cfg.safety, cfg.ifactor,
                              cfg.dfactor, order), state.err_prev)


def adaptive_step(func: Callable, state: AdaptiveState,
                  tableau: ButcherTableau, interp_kind: str,
                  cfg: AdaptiveConfig) -> AdaptiveState:
    """One accept/reject adaptive RK step of every system of the batch,
    from the end of its last accepted step (state.y1 at state.t1): accept
    advances t1 by dt, reject shrinks dt.  All branching is `where`, per
    system; the caller masks systems that have finished."""
    _, fit, _ = INTERP[interp_kind]
    y0, f0, t0, dt = state.y1, state.f1, state.t1, state.dt
    y1, f1, y1_error, y1_error_alt, k = runge_kutta_step(func, y0, f0, t0,
                                                         dt, tableau)
    ratio = error_ratio(y1_error, cfg.rtol, cfg.atol, y0, y1, cfg.floor,
                        cfg.norm_weights)
    if y1_error_alt is not None:
        # DOP853's composite 8(5,3) estimate: with linear ratios e5, e3,
        # err = e5^2 / sqrt(e5^2 + 0.01 e3^2); squared, r5^2 / (r5 + 0.01 r3)
        ratio_alt = error_ratio(y1_error_alt, cfg.rtol, cfg.atol, y0, y1,
                                cfg.floor, cfg.norm_weights)
        denom = torch.clamp_min(ratio + 0.01 * ratio_alt,
                                torch.finfo(ratio.dtype).tiny)
        ratio = ratio * ratio / denom
    accept = ratio <= 1.0
    comp = state.comp
    if cfg.compensated:
        # recommit the increment with the carried compensation folded in,
        # and keep this addition's lost low bits (fast two-sum); f1 stays
        # the slope at the uncompensated y1, an O(eps |y|) difference
        dy = weighted_stage_sum(dt, tableau.c_sol, k)
        d_eff = tree_map(lambda d, c: d + c, dy, state.comp)
        y1 = tree_map(lambda y, d: y + d, y0, d_eff)
        comp = _where(accept, tree_map(lambda d, s, y: d - (s - y), d_eff,
                                       y1, y0), state.comp)
    coeff = _where(accept, fit(func, tableau, y0, y1, k, t0, dt),
                   state.interp_coeff)
    dt_next, err_prev = next_dt(dt, ratio, state, accept, cfg, tableau.order)
    return AdaptiveState(
        y1=_where(accept, y1, y0), f1=_where(accept, f1, f0), t0=t0,
        t1=torch.where(accept, t0 + dt, t0), dt=dt_next, interp_coeff=coeff,
        nfe=state.nfe + tableau.nfe_per_step + INTERP_NFE[interp_kind],
        n_accepted=state.n_accepted + accept.to(state.n_accepted.dtype),
        n_rejected=state.n_rejected + (~accept).to(state.n_rejected.dtype),
        comp=comp, err_prev=err_prev)


def can_step(state: AdaptiveState) -> torch.Tensor:
    """(B,) divergence guard: once a system's error goes non-finite every
    step rejects and dt decays to NaN or 0; such a system stops (with
    reached_final_time False), as on an exhausted budget."""
    return torch.isfinite(state.dt) & (state.dt > 0)


def init_adaptive_state(func: Callable, y0, t0, tableau,
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
        n_rejected=torch.zeros(B, **i64),
        comp=tree_map(torch.zeros_like, y0) if cfg.compensated else None,
        err_prev=(torch.ones_like(dt0) if cfg.controller == "pi" else None))


def select_state(mask, new: AdaptiveState, old: AdaptiveState):
    """`new` where the (B,) mask holds, else `old`, field by field."""
    def pick(a, b):
        if a is None:
            return None
        if torch.is_tensor(a):
            return torch.where(_mask(mask, a), a, b)
        return _where(mask, a, b)

    return AdaptiveState(*(pick(a, b) for a, b in zip(new, old)))


def per_system_times(ts: torch.Tensor, B: int) -> torch.Tensor:
    """Output times (T,) shared by the batch, or (T, B), as (T, B)."""
    return ts[:, None].expand(ts.shape[0], B) if ts.dim() == 1 else ts


def _while_in_place(func, state, tableau, interp_kind, cfg, tb, ys,
                    graph):
    """The "while" loop of `integrate_adaptive` with each step committed in
    place to one state and the output buffers ys: the step of the active
    systems, the outputs it crosses, the next active mask and its any(),
    the one flag the host reads a step.  A replayed step evaluates the
    dense output at every output time (the eager loop only at steps that
    cross one), keeping the values where a system crossed it: the same
    values.  With `graph` the body is captured as a CUDA graph after its
    first steps and each later step replays it (`cuda_graph.GraphedStep`).
    Returns (ys, the final state)."""
    _, _, evaluate = INTERP[interp_kind]
    state = tree_map(torch.clone, state)
    done = torch.zeros(tb.shape, dtype=torch.bool, device=tb.device)
    done[0] = True

    def active_of():
        return ((~done).any(dim=0)
                & (state.n_accepted + state.n_rejected < cfg.max_num_steps)
                & can_step(state))

    active = active_of()
    flag = active.any()

    def body(eager):
        new = select_state(active, adaptive_step(func, state, tableau,
                                                 interp_kind, cfg), state)
        for dst, src in zip(tree_leaves(state), tree_leaves(new)):
            dst.copy_(src)
        emit = (~done) & (tb <= state.t1[None, :]) & active[None, :]
        if not eager or bool(emit.any()):
            vals = evaluate(state.interp_coeff, state.t0, state.t1, tb)
            for out, v in zip(tree_leaves(ys), tree_leaves(vals)):
                out.copy_(torch.where(
                    emit.reshape(emit.shape + (1,) * (out.dim() - 2)), v,
                    out))
            done.logical_or_(emit)
        active.copy_(active_of())
        flag.copy_(active.any())

    step = GraphedStep(body, graph)
    try:
        while bool(flag):
            step()
    finally:
        step.close()
    return ys, state


def integrate_adaptive(func: Callable, y0, ts: torch.Tensor,
                       cfg: AdaptiveConfig, tableau=DOPRI5,
                       interp_kind: str = "quartic",
                       step_impl: Callable = adaptive_step):
    """Integrate y' = func(t, y) for a batch y0 (a tree of (B, ...) leaves)
    at the times ts (T,) or (T, B), increasing.

    func(t (B,), y) -> a tree shaped like y.  step_impl(func, state,
    tableau, interp_kind, cfg) -> state takes a step: `adaptive_step`
    (explicit RK), or `dirk.dirk_step` with a DIRK tableau.  Returns (ys,
    stats): ys a tree of (T, B, ...) leaves with ys[0] == y0, stats the
    per-system nfe / n_accepted / n_rejected / reached_final_time.
    """
    _, _, evaluate = INTERP[interp_kind]
    leaves = tree_leaves(y0)
    B, T, dev = leaves[0].shape[0], ts.shape[0], leaves[0].device
    tb = per_system_times(ts, B)
    state = init_adaptive_state(func, y0, tb[0], tableau, interp_kind, cfg)

    def buffer(leaf):
        out = torch.zeros((T,) + tuple(leaf.shape), dtype=leaf.dtype,
                          device=dev)
        out[0] = leaf
        return out

    def step(active):
        return select_state(active, step_impl(func, state, tableau,
                                              interp_kind, cfg), state)

    if cfg.mode == "bounded":
        # interval by interval, each system at most max_steps_per_interval
        # steps an interval; every system's output is its last step's dense
        # output at the output time, reached or not
        outs = [y0]
        for i in range(1, T):
            for _ in range(cfg.max_steps_per_interval):
                active = (state.t1 < tb[i]) & can_step(state)
                if not bool(active.any()):
                    break
                state = step(active)
            outs.append(evaluate_at(interp_kind, state.interp_coeff,
                                    state.t0, state.t1, tb[i]))
        ys = tree_map(lambda *ls: torch.stack(ls), *outs)
    elif step_impl is adaptive_step and not torch.is_grad_enabled() \
            and graphable(dev):
        ys, state = _while_in_place(func, state, tableau, interp_kind, cfg,
                                    tb, tree_map(buffer, y0),
                                    graph=dev.type == "cuda")
    else:
        ys = tree_map(buffer, y0)
        done = torch.zeros((T, B), dtype=torch.bool, device=dev)
        done[0] = True
        while True:
            active = ((~done).any(dim=0)
                      & (state.n_accepted + state.n_rejected
                         < cfg.max_num_steps)
                      & can_step(state))
            if not bool(active.any()):
                break
            state = step(active)
            emit = (~done) & (tb <= state.t1[None, :]) & active[None, :]
            if bool(emit.any()):
                vals = evaluate(state.interp_coeff, state.t0, state.t1, tb)
                ys = tree_map(lambda o, v: torch.where(
                    emit.reshape(emit.shape + (1,) * (o.dim() - 2)), v, o),
                    ys, vals)
                done = done | emit
    stats = {"nfe": state.nfe, "n_accepted": state.n_accepted,
             "n_rejected": state.n_rejected,
             "reached_final_time": state.t1 >= tb[-1]}
    return ys, stats
