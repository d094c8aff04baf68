"""O(1)-memory exact gradients for SDE solves by the algebraically
reversible Heun method (Kidger, Foster, Li, Lyons 2021, arXiv:2105.13493).

Counterpart of `bayesian_ode_tpu/sde/adjoint.py`.  The step map of
`sdeint(..., method="reversible_heun")` inverts in closed form:

    forward:  yh1 = 2 y - yh + f(t0, yh) h + g(t0, yh) dW
              y1  = y + (f(t0, yh) + f(t1, yh1)) h/2
                      + (g(t0, yh) + g(t1, yh1)) dW/2
    inverse:  yh  = 2 y1 - yh1 - f(t1, yh1) h - g(t1, yh1) dW
              y   = y1 - (f(t0, yh) + f(t1, yh1)) h/2 - (...) dW/2

so the backward pass stores no trajectory: a `torch.autograd.Function`
whose backward loop rebuilds (y_n, yh_n) from (y_{n+1}, yh_{n+1}) step by
step (`_inverse`) and takes one VJP of the self-contained step (`_step`,
one `torch.autograd.grad`) a step.  What it keeps is the final state, the
Brownian increments and the outputs; the drift's and diffusion's
activations are recomputed, never stored, where autograd through
`sdeint` keeps every step's.  The increments' cotangent (as large as the
increments) is formed only when they require grad.

Reconstruction is exact in exact arithmetic; in floating point the
rebuilt trajectory drifts from the forward one at the rounding level
(float32: about 1e-6 relative over hundreds of steps).

Parameters.  Torch has no `closure_convert`: the tensors `drift` and
`diffusion` close over and that need cotangents are given as
`adjoint_params` (the parameters of drift and diffusion when they are
`nn.Module`s), as the port's `ode/adjoint.py` takes them.  They, y0 and
the increments get exact gradients; the time grid gets none (fixed-grid
semantics).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..utils.pytree import Tree, tree_leaves, tree_map, tree_unflatten
from .sdeint import (_apply_noise, _check_noise_type, _grid_tensors,
                     _host_grid, _increments, _noise_template)

__all__ = ["sdeint_adjoint"]


def _params_of(drift, diffusion, adjoint_params):
    if adjoint_params is not None:
        return tuple(adjoint_params)
    params = []
    for fn in (drift, diffusion):
        if isinstance(fn, torch.nn.Module):
            params += [p for p in fn.parameters()
                       if all(p is not q for q in params)]
    return tuple(params)


def sdeint_adjoint(drift: Callable, diffusion: Callable, y0: Tree, ts,
                   generator: Optional[torch.Generator] = None,
                   noise_type: str = "diagonal",
                   options: Optional[Dict[str, Any]] = None,
                   adjoint_params=None) -> Tree:
    """`sdeint` with `method="reversible_heun"` and O(1)-memory reverse
    mode (reversible adjoint).  Same contract as `sdeint`: the path at
    `ts` stacked on a new leading axis; `options={"substeps": k}` refines
    the internal grid; `options={"dW": ...}` supplies the increments
    (leaves stacked (n_steps, *increment), variance dt of the internal
    grid), which also get gradients.
    """
    options = dict(options or {})
    substeps = int(options.pop("substeps", 1))
    dW_user = options.pop("dW", None)
    if options:
        raise ValueError(f"unknown sdeint_adjoint options: {sorted(options)}")
    _check_noise_type(noise_type)
    grid, out_index = _host_grid(ts, substeps)
    device = tree_leaves(y0)[0].device
    times, dts = _grid_tensors(grid, device)
    tmpl = _noise_template(y0, diffusion(times[0], y0), noise_type)
    dW = _increments(tmpl, dW_user, generator, grid, device,
                     "sdeint_adjoint")
    params = _params_of(drift, diffusion, adjoint_params)
    spec = _Spec(drift, diffusion, noise_type, y0, dW, times, dts,
                 [int(i) for i in out_index], len(params))
    y_leaves, w_leaves = tree_leaves(y0), tree_leaves(dW)
    out = _SdeintReversible.apply(spec, *y_leaves, *w_leaves, *params)
    return tree_unflatten(y0, out)


@dataclasses.dataclass
class _Spec:
    """What the Function needs besides tensors: the fields, the noise type,
    the state's and the increments' trees (for their structure), the
    grid's times and steps, the output slots and the parameter count."""
    drift: Callable
    diffusion: Callable
    noise_type: str
    like_y: Any
    like_w: Any
    times: list
    dts: list
    out_index: list
    n_params: int


def _step(spec, n, y, yh, dw):
    """The self-contained reversible-Heun step n: (y, yh) -> (y1, yh1), the
    map of `sdeint`'s cached forward with f(t0, yh) recomputed."""
    t0, t1, dt = spec.times[n], spec.times[n + 1], spec.dts[n]
    f0 = spec.drift(t0, yh)
    g0dW = _apply_noise(spec.diffusion(t0, yh), dw, spec.noise_type)
    yh1 = tree_map(lambda y_, yh_, f_, n_: 2.0 * y_ - yh_ + dt * f_ + n_,
                   y, yh, f0, g0dW)
    f1 = spec.drift(t1, yh1)
    g1dW = _apply_noise(spec.diffusion(t1, yh1), dw, spec.noise_type)
    y1 = tree_map(lambda y_, fa, fb, na, nb:
                  y_ + dt * (fa + fb) / 2 + (na + nb) / 2,
                  y, f0, f1, g0dW, g1dW)
    return y1, yh1


def _inverse(spec, n, y1, yh1, dw):
    """Closed-form inverse of `_step` n: (y1, yh1) -> (y, yh)."""
    t0, t1, dt = spec.times[n], spec.times[n + 1], spec.dts[n]
    f1 = spec.drift(t1, yh1)
    g1dW = _apply_noise(spec.diffusion(t1, yh1), dw, spec.noise_type)
    yh = tree_map(lambda y1_, yh1_, f_, n_: 2.0 * y1_ - yh1_ - dt * f_ - n_,
                  y1, yh1, f1, g1dW)
    f0 = spec.drift(t0, yh)
    g0dW = _apply_noise(spec.diffusion(t0, yh), dw, spec.noise_type)
    y = tree_map(lambda y1_, fa, fb, na, nb:
                 y1_ - dt * (fa + fb) / 2 - (na + nb) / 2,
                 y1, f0, f1, g0dW, g1dW)
    return y, yh


def _increment(spec, w_leaves, n):
    return tree_unflatten(spec.like_w, [w[n] for w in w_leaves])


class _SdeintReversible(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, *args):
        n_y = len(tree_leaves(spec.like_y))
        n_w = len(tree_leaves(spec.like_w))
        y_leaves, w_leaves = args[:n_y], args[n_y:n_y + n_w]
        y0 = tree_unflatten(spec.like_y, y_leaves)
        outputs = set(spec.out_index)
        y, yh, outs = y0, y0, [y0]
        for n in range(len(spec.dts)):
            y, yh = _step(spec, n, y, yh, _increment(spec, w_leaves, n))
            if n + 1 in outputs:
                outs.append(y)
        ctx.spec = spec
        ctx.save_for_backward(*tree_leaves(y), *tree_leaves(yh), *w_leaves,
                              *args[n_y + n_w:])
        return tuple(torch.stack(leaves) for leaves
                     in zip(*(tree_leaves(o) for o in outs)))

    @staticmethod
    def backward(ctx, *ys_bar):
        spec = ctx.spec
        saved = ctx.saved_tensors
        n_y = len(tree_leaves(spec.like_y))
        n_w = len(tree_leaves(spec.like_w))
        y1 = tree_unflatten(spec.like_y, saved[:n_y])
        yh1 = tree_unflatten(spec.like_y, saved[n_y:2 * n_y])
        w_leaves = saved[2 * n_y:2 * n_y + n_w]
        params = saved[2 * n_y + n_w:]
        need_w = any(ctx.needs_input_grad[1 + n_y:1 + n_y + n_w])
        ys_bar = [torch.zeros_like(b) if b is None else b for b in ys_bar]
        slot = {n: k for k, n in enumerate(spec.out_index)}
        ybar = [torch.zeros_like(x) for x in saved[:n_y]]
        yhbar = [torch.zeros_like(x) for x in saved[:n_y]]
        pbar = [torch.zeros_like(p) for p in params]
        wbar = ([torch.zeros_like(w) for w in w_leaves] if need_w else None)
        for n in reversed(range(len(spec.dts))):
            if n + 1 in slot:       # node n+1's output adds to y's cotangent
                ybar = [a + b[slot[n + 1]] for a, b in zip(ybar, ys_bar)]
            dw = _increment(spec, w_leaves, n)
            with torch.no_grad():
                y, yh = _inverse(spec, n, y1, yh1, dw)
            with torch.enable_grad():
                y_in = tree_map(lambda x: x.detach().requires_grad_(True), y)
                yh_in = tree_map(lambda x: x.detach().requires_grad_(True),
                                 yh)
                dw_in = (tree_map(lambda x: x.detach().requires_grad_(True),
                                  dw) if need_w else dw)
                out_y, out_yh = _step(spec, n, y_in, yh_in, dw_in)
                inputs = (tree_leaves(y_in) + tree_leaves(yh_in)
                          + (tree_leaves(dw_in) if need_w else [])
                          + [p for p in params if p.requires_grad])
                grads = torch.autograd.grad(
                    tree_leaves(out_y) + tree_leaves(out_yh), inputs,
                    ybar + yhbar, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for g, x in zip(grads, inputs)]
            ybar, yhbar = grads[:n_y], grads[n_y:2 * n_y]
            rest = grads[2 * n_y:]
            if need_w:
                for w, g in zip(wbar, rest[:n_w]):
                    w[n] = g
                rest = rest[n_w:]
            it = iter(rest)
            pbar = [pb + next(it) if p.requires_grad else pb
                    for pb, p in zip(pbar, params)]
            y1, yh1 = y, yh
        # node 0 emits y0 itself (out_index[0] == 0): its cotangent is direct
        y0_bar = [a + b + c[0] for a, b, c in zip(ybar, yhbar, ys_bar)]
        w_out = wbar if need_w else [None] * n_w
        return (None, *y0_bar, *w_out, *pbar)
