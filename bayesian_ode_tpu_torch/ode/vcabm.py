"""Variable-coefficient Adams-Bashforth-Moulton ("adams"), orders 1 to 12,
batched.

Counterpart of `bayesian_ode_tpu/ode/vcabm.py` (Hairer, Norsett & Wanner,
"Solving ODEs I", III.5; reference torchdiffeq/_impl/adams.py).  Every
system of the batch keeps its own step, order (B,), past times prev_t
(max_order + 1, B) and divided-difference history phi (leaves
(max_order, B, ...)), newest first; the order indexes the zero-padded
coefficient vectors by a per-system gather.  The batch steps in masked
lockstep, one host read of the active mask a step.  Each output time
clamps the step to it, and the output is the state there (no
interpolation).  Without autograd, on a CUDA stream other than the
default one, the "while" loop commits each step in place and replays it
as one CUDA graph (`run_in_place`).

Quirks of the reference kept for parity, as the JAX package keeps them:
  - on acceptance the *predictor* is stored as the solution, though the
    corrector drives the error estimate and the history;
  - the order is capped at 3 until more than 4 steps have been taken.

One departure from the JAX package: a system at max_order reads its
error estimate from implicit phi[max_order], which the reference computes
(torchdiffeq's compute_implicit_phi builds order + 1 entries) and the JAX
package's gather reads past its max_order entries as NaN, so its step
rejects with a NaN step size and the system stalls until its budget runs
out (at the default max_order 12, 1 system in 4,096 of Van der Pol at
rtol 1e-7 over [0, 6]; at max_order 4 every system within 5 steps).  The
port computes that entry as the reference does; every system that never
reaches max_order takes the JAX package's steps.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.pytree import tree_leaves, tree_map, tree_unflatten
from .cuda_graph import GraphedStep, graphable
from .runge_kutta import _bcast
from .step_control import optimal_step_size, select_initial_step

_MAX_ORDER = 12

# gamma* coefficients (Hairer III.5)
_GAMMA_STAR = [
    1, -1 / 2, -1 / 12, -1 / 24, -19 / 720, -3 / 160, -863 / 60480,
    -275 / 24192, -33953 / 3628800, -0.00789255, -0.00678585, -0.00592406,
    -0.00523669, -0.0046775, -0.00421495, -0.0038269,
]


class VCABMState(NamedTuple):
    y_n: object
    prev_t: torch.Tensor   # (max_order + 1, B), newest first
    next_t: torch.Tensor   # (B,)
    phi: object            # leaves (max_order, B, ...)
    order: torch.Tensor    # (B,)
    count: torch.Tensor    # (B,) valid prev_t entries
    nfe: torch.Tensor
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor


def _safe_div(a, b):
    return a / torch.where(b == 0, torch.ones_like(b), b)


def _g_coeffs_and_betas(prev_t, next_t, dt, max_order):
    """g (max_order + 1, B) quadrature weights and betas (max_order, B),
    each system's; entries past its order are never read.  The c vector
    of the recursion loses its last entry each round (the JAX package
    carries it unchanged and never reads it)."""
    L = max_order + 2
    B = prev_t.shape[1]
    c = (1.0 / torch.arange(1, L + 1, dtype=prev_t.dtype,
                            device=prev_t.device))[:, None].expand(L, B)
    curr_t = prev_t[0]
    q = _safe_div(dt, next_t - prev_t[:max_order])
    r = _safe_div(next_t - prev_t[:max_order - 1],
                  curr_t - prev_t[1:max_order])
    one = torch.ones_like(curr_t)
    g, betas, beta = [one], [one], one
    for j in range(1, max_order + 1):
        if j < max_order:
            beta = beta * r[j - 1]
            betas.append(beta)
        c = c[:-1] - c[1:] * q[j - 1]
        g.append(c[0])
    return torch.stack(g), torch.stack(betas)


def _per_system(x, leaf):
    """(K, B) -> shaped against a (K, B, ...) leaf, in its dtype."""
    return x.to(leaf.dtype).reshape(x.shape + (1,) * (leaf.dim() - 2))


def _implicit_phi(ephi, f_new):
    """iphi[j] = f_new - sum_{i<j} ephi[i], j = 0..max_order, by a
    cumulative sum: one entry more than phi, the one a step at
    max_order reads for its error estimate (the reference's)."""
    def leaf(e, f):
        prefix = torch.cumsum(e, dim=0)
        return f[None] - torch.cat([torch.zeros_like(f)[None], prefix])

    return tree_map(leaf, ephi, f_new)


def _take(x, idx, ar):
    """x[idx[b], b] along the leading axis of x (K, B, ...); ar is
    arange(B)."""
    return x[idx, ar]


def _take0(tree, idx, ar):
    return tree_map(lambda x: _take(x, idx, ar), tree)


def _leaf_sq_ratios(err, tol, segments=None):
    """(n_leaves, B): each leaf's mean squared error / tolerance ratio.
    With `segments` err and tol are tuples of raveled (B, n_g) tensors,
    one a dtype, and segments[g] the sizes of group g's leaves, each leaf
    its run of columns."""
    if segments is not None:
        return torch.stack([part.mean(dim=1)
                            for e, s, sizes in zip(err, tol, segments)
                            for part in torch.split((e / s) ** 2, sizes,
                                                    dim=1)])
    return torch.stack([((e / s) ** 2).reshape(e.shape[0], -1).mean(dim=1)
                        for e, s in zip(tree_leaves(err), tree_leaves(tol))])


def _ravel_by_dtype(tree):
    """(ravel, unravel, segments): a tree of (B, ...) leaves as a tuple of
    (B, n_g) tensors, one a dtype (each leaf keeps its own), and back;
    segments[g] lists group g's leaf sizes."""
    leaves = tree_leaves(tree)
    groups = [[i for i, l in enumerate(leaves) if l.dtype == d]
              for d in sorted({l.dtype for l in leaves}, key=str)]
    shapes = [tuple(l.shape[1:]) for l in leaves]
    sizes = [l[0].numel() for l in leaves]

    def ravel(t):
        ls = tree_leaves(t)
        return tuple(torch.cat([ls[i].reshape(ls[i].shape[0], -1)
                                for i in g], dim=1) for g in groups)

    def unravel(vs):
        out = [None] * len(leaves)
        for g, v in zip(groups, vs):
            for i, part in zip(g, torch.split(v, [sizes[i] for i in g],
                                              dim=1)):
                out[i] = part.reshape((v.shape[0],) + shapes[i])
        return tree_unflatten(tree, out)

    return ravel, unravel, tuple([sizes[i] for i in g] for g in groups)


def vcabm_step(func, state: VCABMState, final_t, active, rtol, atol,
               max_order, safety, ifactor, dfactor, gamma_star,
               segments=None) -> VCABMState:
    """One predictor-corrector step toward final_t (B,) of the systems
    where `active` (B,) holds, accepted or rejected per system; the
    others keep their state.  `segments`: the leaf sizes of a raveled
    state, for the per-leaf error norms."""
    y0_, prev_t, order = state.y_n, state.prev_t, state.order
    next_t = torch.minimum(state.next_t, final_t)
    dt = next_t - prev_t[0]
    g, betas = _g_coeffs_and_betas(prev_t, next_t, dt, max_order)
    casts = {}

    def cast(x, like, history=False):
        """Time-dtype x ((B,), or (K, B) with `history`) in like's dtype,
        shaped against it; one cast a dtype, whatever the leaves."""
        key = (id(x), like.dtype)
        if key not in casts:
            casts[key] = (x, x.to(like.dtype))
        return (_per_system(casts[key][1], like) if history
                else _bcast(casts[key][1], like))

    ephi = tree_map(lambda p: p * cast(betas, p, True), state.phi)

    # explicit predictor: y0 + dt sum_{j < max(1, order - 1)} g[j] phi*[j]
    pred_len = torch.clamp_min(order - 1, 1)
    idxs = torch.arange(max_order, device=order.device)[:, None]
    w_pred = torch.where(idxs < pred_len[None], g[:max_order],
                         torch.zeros_like(g[:max_order]))
    p_next = tree_map(
        lambda y, e: y + cast(dt, e[0]) * (cast(w_pred, e, True) * e).sum(0),
        y0_, ephi)
    f_pred = func(next_t, p_next)
    iphi_p = _implicit_phi(ephi, f_pred)
    ar = torch.arange(order.shape[0], device=order.device)

    # implicit corrector: p + dt g[order-1] iphi_p[order-1]
    g_om1 = _take(g, order - 1, ar)
    dt_g = dt * g_om1
    y_next = tree_map(lambda p, ip: p + cast(dt_g, p) * ip, p_next,
                      _take0(iphi_p, order - 1, ar))
    tol = tree_map(lambda a, b: atol + rtol * torch.maximum(a.abs(),
                                                            b.abs()),
                   y0_, y_next)

    def sq_ratios(coef, idx):
        dt_c = dt * coef
        return _leaf_sq_ratios(
            tree_map(lambda ip: cast(dt_c, ip) * ip,
                     _take0(iphi_p, idx, ar)), tol, segments)

    g_o = _take(g, order, ar)
    error_k = sq_ratios(g_o - g_om1, order).max(dim=0).values
    accept = error_k <= 1.0

    dt_rej = optimal_step_size(dt, error_k, safety, ifactor, dfactor, order)
    next_t_rej = prev_t[0] + dt_rej

    f_corr = func(next_t, y_next)
    iphi = _implicit_phi(ephi, f_corr)

    # order adaptation
    om2 = torch.clamp_min(order - 2, 0)
    g_om2 = _take(g, om2, ar)
    g_om3 = _take(g, torch.clamp_min(order - 3, 0), ar)
    err_km1 = sq_ratios(g_om1 - g_om2, torch.clamp_min(order - 1, 0))
    err_km2 = sq_ratios(g_om2 - g_om3, om2)
    err_kp1 = sq_ratios(gamma_star[order], order)
    lower = torch.minimum(err_km1.min(dim=0).values,
                          err_km2.min(dim=0).values) < error_k
    raise_ok = (order < max_order) & (err_kp1.max(dim=0).values < error_k)
    adapted = torch.where(lower, order - 1,
                          torch.where(raise_ok, order + 1, order))
    startup = (state.count <= 4) | (order < 3)
    next_order = torch.where(
        startup, torch.clamp_max(torch.clamp_max(order + 1, 3), max_order),
        adapted)
    dt_acc = torch.where(next_order > order, dt,
                         optimal_step_size(dt, error_k, safety, ifactor,
                                           dfactor, order + 1))
    prev_t_acc = torch.cat([next_t[None], prev_t[:-1]])

    # one select a field: the step's own accept/reject, and systems that
    # are not active keep their state
    acc = accept & active
    step = VCABMState(
        y_n=p_next, prev_t=prev_t_acc, next_t=torch.where(
            accept, next_t + dt_acc, next_t_rej),
        phi=tree_map(lambda x: x[:-1], iphi), order=next_order,
        count=torch.clamp_max(state.count + 1, max_order + 1),
        nfe=state.nfe + 1 + accept.to(state.nfe.dtype),
        n_accepted=state.n_accepted + accept.to(state.n_accepted.dtype),
        n_rejected=state.n_rejected + (~accept).to(state.n_rejected.dtype))
    masks = {"next_t": active, "nfe": active, "n_accepted": active,
             "n_rejected": active}
    return VCABMState(*(
        _select(masks.get(name, acc), new, old, history=name in (
            "prev_t", "phi"))
        for name, new, old in zip(VCABMState._fields, step, state)))


def _select(mask, new, old, history=False):
    """`new` where the (B,) mask holds, else `old`, leafwise; history
    leaves carry the batch on their second axis."""
    def pick(x, y):
        shape = ((1, -1) + (1,) * (x.dim() - 2) if history
                 else (-1,) + (1,) * (x.dim() - 1))
        return torch.where(mask.reshape(shape), x, y)

    return tree_map(pick, new, old)


def init_vcabm_state(func, y0, t0, rtol, atol, max_order) -> VCABMState:
    """The state at t0 (B,): f0, the Hairer start step at order 2 (nfe
    2), order 1 and phi[0] = f0."""
    leaves = tree_leaves(y0)
    B, dev = leaves[0].shape[0], leaves[0].device
    f0 = func(t0, y0)
    first_step = select_initial_step(func, t0, y0, 2, rtol, atol, f0)
    phi0 = tree_map(lambda f: torch.cat(
        [f[None], torch.zeros((max_order - 1,) + tuple(f.shape),
                              dtype=f.dtype, device=dev)]), f0)
    i64 = dict(dtype=torch.int64, device=dev)
    return VCABMState(
        y_n=y0, prev_t=t0[None].expand(max_order + 1, B).clone(),
        next_t=t0 + first_step, phi=phi0, order=torch.ones(B, **i64),
        count=torch.ones(B, **i64), nfe=torch.full((B,), 2, **i64),
        n_accepted=torch.zeros(B, **i64), n_rejected=torch.zeros(B, **i64))


def run_in_place(func, y0, state, tb, step_args, active_of, bound,
                 graph=False):
    """The "while" loop over the output times tb (T, B), each step
    committed in place to one state: the step of the active systems, its
    copy into the state, the next active mask and its any(), the one
    flag the host reads a step.  With `graph` that body is captured as a
    CUDA graph after its first steps and each later step replays it
    (`cuda_graph.GraphedStep`): the same kernels on the same inputs, one
    launch where the eager loop makes a few hundred.  At most `bound`
    steps an interval.  Returns (y0 and the states at tb[1:], the final
    state)."""
    state = tree_map(torch.clone, state)
    final_t = tb[-1].clone()
    active = active_of(state, final_t)
    flag = active.any()

    def body(eager):
        new = vcabm_step(func, state, final_t, active, *step_args)
        for dst, src in zip(tree_leaves(state), tree_leaves(new)):
            dst.copy_(src)
        active.copy_(active_of(state, final_t))
        flag.copy_(active.any())

    step = GraphedStep(body, graph)
    outs = [y0]
    try:
        for i in range(1, tb.shape[0]):
            final_t.copy_(tb[i])
            active.copy_(active_of(state, final_t))
            flag.copy_(active.any())
            for _ in range(bound):
                if not bool(flag):
                    break
                step()
            outs.append(tree_map(torch.clone, state.y_n))
    finally:
        step.close()
    return outs, state


def integrate_vcabm(func: Callable, y0, ts: torch.Tensor, rtol: float,
                    atol: float, max_order: int = _MAX_ORDER,
                    safety: float = 0.9, ifactor: float = 10.0,
                    dfactor: float = 0.2, max_num_steps: int = 2**20,
                    mode: str = "while", max_steps_per_interval: int = 256):
    """Integrate a batch y0 (leaves (B, ...)) at the increasing times ts
    (T,) or (T, B).  func(t (B,), y).  mode "while": each interval until
    every system reaches its output time or its step budget; "bounded":
    at most max_steps_per_interval steps an interval (autograd through the
    loop, as through the JAX package's bounded scan).  Returns (ys (T, B,
    ...), per-system stats)."""
    if mode not in ("while", "bounded"):
        raise ValueError(f"unknown vcabm mode: {mode!r}")
    from .adaptive import per_system_times

    max_order = int(max(1, min(max_order, _MAX_ORDER)))
    leaves = tree_leaves(y0)
    B = leaves[0].shape[0]
    tb = per_system_times(ts, B)
    segments, unravel = None, None
    if len(leaves) > 1:
        # step on the state raveled into one (B, n) tensor a dtype: the
        # same arithmetic in far fewer operations
        ravel, unravel, segments = _ravel_by_dtype(y0)
        y0 = ravel(y0)
        base = func

        def func(t, v):
            return ravel(base(t, unravel(v)))
    gamma_star = torch.as_tensor(_GAMMA_STAR, dtype=ts.dtype,
                                 device=ts.device)
    state = init_vcabm_state(func, y0, tb[0], rtol, atol, max_order)
    step_args = (rtol, atol, max_order, safety, ifactor, dfactor, gamma_star,
                 segments)

    def active_of(state, final_t):
        # a system whose step size went non-finite (its state diverged)
        # can take no step: it stops, as the adaptive loop's can_step
        # stops it, where the JAX loop spins out its budget of rejections
        active = (state.prev_t[0] < final_t) & torch.isfinite(state.next_t)
        if mode == "while":
            active = active & (state.n_accepted + state.n_rejected
                               < max_num_steps)
        return active

    dev = leaves[0].device
    if mode == "while" and not torch.is_grad_enabled() and graphable(dev):
        outs, state = run_in_place(func, y0, state, tb, step_args,
                                   active_of, max_num_steps + 1,
                                   graph=dev.type == "cuda")
    else:
        outs = [y0]
        for i in range(1, tb.shape[0]):
            final_t = tb[i]
            for it in range(max_steps_per_interval if mode == "bounded"
                            else max_num_steps + 1):
                active = active_of(state, final_t)
                if not bool(active.any()):
                    break
                state = vcabm_step(func, state, final_t, active, *step_args)
            outs.append(state.y_n)
    if unravel is not None:
        outs = [unravel(v) for v in outs]
    ys = tree_map(lambda *ls: torch.stack(ls), *outs)
    stats = {"nfe": state.nfe, "n_accepted": state.n_accepted,
             "n_rejected": state.n_rejected,
             "reached_final_time": state.prev_t[0] >= tb[-1]}
    return ys, stats
