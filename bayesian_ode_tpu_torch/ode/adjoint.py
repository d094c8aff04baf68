"""Continuous-adjoint gradients for `odeint` as a `torch.autograd.Function`
over a batch of systems.

Counterpart of `bayesian_ode_tpu/ode/adjoint.py` (reference:
torchdiffeq/_impl/adjoint.py).  The forward is the batched adaptive or
fixed-grid solve without a graph.  The backward loops over the output
intervals i = T-1..1: it adds the observation time's cotangent
dL/dt_i = f(t_i, y_i) . g_i, integrates the augmented system
(y, a_y, a_t, a_params) from -t_i to -t_{i-1} (the time-reversal trick),
and adds the next output's cotangent to a_y.  Each system of the batch
keeps its own step size and accept/reject decisions in the backward solve
too, with its error norm over its own augmented leaves, as the JAX
package's vmap of the per-chain solve has.

Parameters.  Torch has no `closure_convert`: the tensors the field closes
over and that need cotangents are given as `adjoint_params` (the
parameters of `func` when it is an `nn.Module`, as upstream torchdiffeq
takes them).  Each RHS VJP is one `torch.autograd.grad` of
sum(f(t, y) * (-a_y)) with respect to (t, y, params) over the whole
batch; in a batch every parameter carries the leading system axis, so the
one call gives each system's own VJP.  Parameters are error-controlled
leaves of the backward solve unless adjoint_options={"norm": "seminorm"}
gives them weight 0.  a_t is in the time dtype (float64); each leaf keeps
its own dtype.

Second order.  A backward pass with create_graph=True (a Hessian by
reverse over reverse, as `jax.jacrev(jax.grad(...))` takes it through the
JAX package's custom_vjp) differentiates the backward rule itself: the
saved trajectory is recomputed from y0 and the parameters through this
Function (so its own derivative is again the continuous adjoint, as the
JAX residuals are the custom_vjp's outputs), and the backward solve runs
with a graph through the fixed-grid solver's steps.  At an adaptive
adjoint method this raises ValueError, where the JAX package's reverse
pass through the backward solve's while loop raises.

Every method of `odeint.SOLVERS` serves as the forward and the adjoint
method.  Complex states are solved view-as-real (`odeint.complex_to_real`),
so their cotangents are torch's for `torch.view_as_real`; the JAX
package's adjoint rejects them.

`nfe_counts` sums the RHS evaluations of every system in the forward and
backward solves (read it, set it to 0, divide by the batch).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..utils.pytree import tree_leaves, tree_map, tree_unflatten
from .odeint import (ADAPTIVE_METHODS, as_times, check_method,
                     complex_to_real, reverse_time, solve_batched, unbatch)

# the adjoint methods whose backward solve has a data-dependent loop: a
# create_graph pass through them raises, as the JAX package's reverse pass
# through a while loop does (the fixed Adams corrector's included)
_LOOPED = ADAPTIVE_METHODS + ("fixed_adams",)

nfe_counts = {"forward": 0, "backward": 0}


def _params_of(func, adjoint_params):
    if adjoint_params is not None:
        return tuple(adjoint_params)
    if isinstance(func, torch.nn.Module):
        return tuple(func.parameters())
    return ()


def odeint_adjoint(func: Callable, y0, t, rtol: float = 1e-6,
                   atol: float = 1e-12, method: Optional[str] = None,
                   options: Optional[Dict[str, Any]] = None,
                   adjoint_rtol: Optional[float] = None,
                   adjoint_atol: Optional[float] = None,
                   adjoint_method: Optional[str] = None,
                   adjoint_options: Optional[Dict[str, Any]] = None,
                   adjoint_params=None, batched: bool = False):
    """`odeint` with gradients by the continuous adjoint ODE, for y0, t and
    the tensors in `adjoint_params`.

    The defaults are the reference's (rtol 1e-6, atol 1e-12); the adjoint
    tolerances, method and options fall back to the forward ones.  With
    `batched=True` every leaf of y0 carries a leading system axis B,
    func(t (B,), y) sees the whole batch, and every adjoint parameter
    carries the same leading axis (one copy a system).
    """
    if options is not None and method is None:
        raise ValueError("cannot supply `options` without specifying "
                         "`method`")
    method = method or "dopri5"
    check_method(method)
    check_method(adjoint_method or method)
    params = _params_of(func, adjoint_params)
    func, y0, unpack = complex_to_real(func, y0)
    dev = tree_leaves(y0)[0].device
    ts = as_times(t, dev, batched)
    # decreasing time: negate outside the Function, so the ts cotangent
    # picks up the sign through autograd
    func, ts = reverse_time(func, ts)
    if not batched:
        func, y0 = unbatch(func, y0)
    B = tree_leaves(y0)[0].shape[0]
    for p in params:
        if batched and (p.dim() == 0 or p.shape[0] != B):
            raise ValueError(
                "in a batch every adjoint parameter carries the leading "
                f"system axis ({B}); got a parameter of shape "
                f"{tuple(p.shape)}: give each system its own copy")
    spec = _Spec(func, y0, params, batched, float(rtol), float(atol), method,
                 dict(options or {}),
                 float(rtol if adjoint_rtol is None else adjoint_rtol),
                 float(atol if adjoint_atol is None else adjoint_atol),
                 adjoint_method or method,
                 dict(adjoint_options if adjoint_options is not None
                      else options or {}))
    leaves = tree_leaves(y0)
    if ts.shape[0] < 2:
        ys = tree_map(lambda l: l.unsqueeze(0), y0)
    else:
        out = _OdeintAdjoint.apply(spec, ts, *leaves, *params)
        ys = tree_unflatten(y0, out)
    if not batched:
        ys = tree_map(lambda l: l[:, 0], ys)
    return unpack(ys)


@dataclasses.dataclass
class _Spec:
    """What the Function needs besides tensors: the batched field, y0's
    tree (for its structure), the parameters and the two solves'
    settings."""
    func: Callable
    like: Any
    params: tuple
    batched: bool
    rtol: float
    atol: float
    method: str
    options: Dict[str, Any]
    adjoint_rtol: float
    adjoint_atol: float
    adjoint_method: str
    adjoint_options: Dict[str, Any]


def _per_system_dot(a, b, dtype):
    """(B,) sum over each system's elements of a * b across leaves."""
    return sum((x * y).reshape(x.shape[0], -1).sum(dim=1).to(dtype)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


class _OdeintAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, ts, *args):
        n_y = len(tree_leaves(spec.like))
        y0 = tree_unflatten(spec.like, args[:n_y])
        with torch.no_grad():
            ys, stats = solve_batched(spec.func, y0, ts, spec.rtol,
                                      spec.atol, spec.method, spec.options)
        nfe_counts["forward"] += int(stats["nfe"].sum())
        ys = tuple(tree_leaves(ys))
        ctx.spec = spec
        ctx.save_for_backward(ts, *ys, *args[:n_y])
        return ys

    @staticmethod
    def backward(ctx, *grad_ys):
        spec = ctx.spec
        n_y = len(tree_leaves(spec.like))
        ts, *saved = ctx.saved_tensors
        ys, y0 = saved[:n_y], saved[n_y:]
        grad_ys = [torch.zeros_like(y) if g is None else g
                   for g, y in zip(grad_ys, ys)]
        if not torch.is_grad_enabled():
            with torch.no_grad():
                return (None,) + _backward(spec, ts, ys, grad_ys)
        # a create_graph pass: differentiate the backward rule
        if (spec.adjoint_method in _LOOPED
                and (spec.adjoint_method == "fixed_adams"
                     or spec.adjoint_options.get("mode", "while")
                     != "bounded")):
            raise ValueError(
                "second-order derivatives through odeint_adjoint need a "
                f"fixed-grid adjoint method (got {spec.adjoint_method!r}): "
                "the backward solve's adaptive loop is not differentiated, "
                "as the JAX package's reverse pass through its while loop "
                "raises 'Reverse-mode differentiation does not work for "
                "lax.while_loop'")
        ys = _OdeintAdjoint.apply(spec, ts, *y0, *spec.params)
        return (None,) + _backward(spec, ts, ys, grad_ys, create_graph=True)


class _Reattach(torch.autograd.Function):
    """outs, computed from detached copies `detached` of the tensors
    `attached`, with their derivative through `attached` restored: the
    backward sends each cotangent on into outs' own graph (the parameters
    and the cotangent state) and, through outs' derivative in `detached`,
    to `attached`."""

    @staticmethod
    def forward(ctx, graph, *args):
        outs, detached = graph
        ctx.graph = graph
        ctx.n_att = len(detached)
        return tuple(o.clone() for o in args[ctx.n_att:])

    @staticmethod
    def backward(ctx, *ws):
        outs, detached = ctx.graph
        live = [i for i, o in enumerate(outs) if o.requires_grad]
        g = torch.autograd.grad(
            [outs[i] for i in live], detached,
            grad_outputs=[ws[i] for i in live], retain_graph=True,
            allow_unused=True, create_graph=torch.is_grad_enabled()) \
            if live else [None] * len(detached)
        g = [torch.zeros_like(d) if x is None else x
             for x, d in zip(g, detached)]
        return (None, *g, *(w if o.requires_grad else None
                            for w, o in zip(ws, outs)))


def _backward(spec, ts, ys, grad_ys, create_graph=False):
    """The adjoint sweep over the output intervals.  With create_graph the
    cotangents it returns are differentiable in ys, grad_ys and the
    parameters (the RHS VJPs keep their graph and the backward solve
    runs under autograd)."""
    func, like = spec.func, spec.like
    T = ts.shape[0]
    B = ys[0].shape[1]
    # the parameters that need cotangents; the others get None
    wanted = [i for i, p in enumerate(spec.params) if p.requires_grad]
    params = [spec.params[i] for i in wanted]
    shaped = (lambda g: g) if spec.batched else (lambda g: g.unsqueeze(0))

    def augmented(t, aug):
        y, a_y, _, _ = aug
        with torch.enable_grad():
            t_ = t.detach().requires_grad_(True)
            y_ = tree_map(lambda l: l.detach().requires_grad_(True), y)
            f = func(t_, y_)
            y_leaves = tree_leaves(y_)
            grads = torch.autograd.grad(
                tree_leaves(f), [t_] + y_leaves + params,
                grad_outputs=[-a for a in tree_leaves(a_y)],
                allow_unused=True, create_graph=create_graph)
        inputs = [t_] + y_leaves + params
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, inputs)]
        outs = tree_leaves(f) + grads
        if create_graph:
            # the VJP's partials are taken at detached y (its graph runs
            # back into the recomputed trajectory, hence the parameters);
            # the derivative through y is restored here
            outs = _Reattach.apply((outs, y_leaves), *tree_leaves(y), *outs)
        else:
            outs = [x.detach() for x in outs]
        n_f = len(tree_leaves(f))
        f, grads = tree_unflatten(f, outs[:n_f]), outs[n_f:]
        vjp_t = grads[0]
        vjp_y = tree_unflatten(y, grads[1:1 + len(y_leaves)])
        vjp_p = tuple(shaped(g) for g in grads[1 + len(y_leaves):])
        return (f, vjp_y, vjp_t, vjp_p)

    def reverse(s, aug):
        return tree_map(torch.neg, augmented(-s, aug))

    options = dict(spec.adjoint_options)
    norm = options.pop("norm", None)
    if norm not in (None, "seminorm"):
        raise ValueError(f"unknown adjoint norm {norm!r}; expected "
                         "'seminorm'")

    a_y = tree_unflatten(like, [g[-1] for g in grad_ys])
    a_t = torch.zeros(B, dtype=ts.dtype, device=ts.device)
    a_p = tuple(shaped(torch.zeros_like(p)) for p in params)
    dLd_ts = []
    for i in range(T - 1, 0, -1):
        y_i = tree_unflatten(like, [y[i] for y in ys])
        g_i = tree_unflatten(like, [g[i] for g in grad_ys])
        t_i = ts[i].expand(B)
        dLd_t = _per_system_dot(func(t_i, y_i), g_i, ts.dtype)
        dLd_ts.append(dLd_t)
        a_t = a_t - dLd_t
        aug0 = (y_i, a_y, a_t, a_p)
        if norm == "seminorm":
            options["norm_weights"] = (
                tree_map(lambda _: 1.0, y_i), tree_map(lambda _: 1.0, a_y),
                1.0, tuple(0.0 for _ in a_p))
        span = torch.stack([-ts[i], -ts[i - 1]])
        out, stats = solve_batched(reverse, aug0, span, spec.adjoint_rtol,
                                   spec.adjoint_atol, spec.adjoint_method,
                                   options)
        nfe_counts["backward"] += int(stats["nfe"].sum())
        _, a_y, a_t, a_p = tree_map(lambda x: x[-1], out)
        a_y = tree_map(lambda a, g: a + g[i - 1], a_y,
                       tree_unflatten(like, grad_ys))
    # the ts cotangent [a_t, dL/dt_1, ..., dL/dt_{T-1}], summed over the
    # systems that share ts (per system where each has its own)
    t_vjps = torch.stack([a_t] + dLd_ts[::-1], dim=0)
    if ts.dim() == 1:
        t_vjps = t_vjps.sum(dim=1)
    p_grads = [None] * len(spec.params)
    for j, i in enumerate(wanted):
        g = a_p[j]
        p_grads[i] = g if spec.batched else g[0]
    return (t_vjps,) + tuple(tree_leaves(a_y)) + tuple(p_grads)
