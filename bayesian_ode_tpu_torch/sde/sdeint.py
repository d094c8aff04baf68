"""Fixed-grid SDE solvers of the port: one Python loop over a host grid.

Counterpart of `bayesian_ode_tpu/sde/sdeint.py`:

    ys = sdeint(drift, diffusion, y0, ts, generator, method=...,
                options=...)

- `drift(t, y) -> dy/dt` and `diffusion(t, y) -> g` over a tensor or a
  tree of tensors `y` (dict, list, tuple), `odeint`'s right-hand-side
  contract; `t` is a 0-dim float64 tensor on the state's device;
- the path is one loop over a grid built on the host in float64; autograd
  differentiates the loop directly, and `options={"checkpoint": True}`
  recomputes each step in the backward pass (`torch.utils.checkpoint`);
- Brownian increments are drawn up front from `generator` (a
  `torch.Generator` on the state's device), all steps at once, each leaf
  as N(0, dt) of shape (n_steps, *increment), or supplied explicitly via
  `options={"dW": ...}`.  The JAX package draws from per-step key
  splits, so the two packages' streams differ: parity goes through `dW`.
  One generator stream serves the whole batch, so a batch row's path
  depends on the batch's shape (torch's normal sampler fills a tensor in
  blocks, and on the card by launch geometry); the same generator state
  and shapes give the same path;
- batching is the state's own leading axes (elementwise noise).

Methods: "euler_maruyama" (Ito), "milstein" (Ito, the diagonal-noise
correction 0.5 (dg·g)(y) (dW^2 - dt) with dg·g a `torch.func.jvp` of g
along g), "heun" (Stratonovich predictor-corrector) and "reversible_heun"
(Kidger et al. 2021, one drift and diffusion evaluation a step, carried,
and an algebraically invertible step: the basis of `sdeint_adjoint`).

Noise types: "diagonal" (g shaped like y, one increment an element) and
"general" (single-tensor states (..., D), g (..., D, M) against an
M-dimensional Brownian motion; not with milstein).

Only increasing concrete time grids: `options={"substeps": k}` takes k
equal internal steps an output interval.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from ..utils.pytree import Tree, tree_leaves, tree_map, tree_unflatten

__all__ = ["sdeint", "SDE_METHODS"]


def _em_step(drift, diffusion, noise_type, t0, t1, dt, y, dW):
    f0 = drift(t0, y)
    gdW = _apply_noise(diffusion(t0, y), dW, noise_type)
    return tree_map(lambda y_, f_, n_: y_ + dt * f_ + n_, y, f0, gdW)


def _milstein_step(drift, diffusion, noise_type, t0, t1, dt, y, dW):
    if noise_type != "diagonal":
        raise ValueError(
            "milstein supports noise_type='diagonal' only (general noise "
            "needs Levy-area simulation)")
    f0 = drift(t0, y)
    g0, dg_g = torch.func.jvp(lambda yy: diffusion(t0, yy), (y,),
                              (diffusion(t0, y),))

    def upd(y_, f_, g_, dgg_, dw_):
        return y_ + dt * f_ + g_ * dw_ + 0.5 * dgg_ * (dw_ * dw_ - dt)

    return tree_map(upd, y, f0, g0, dg_g, dW)


def _heun_step(drift, diffusion, noise_type, t0, t1, dt, y, dW):
    f0 = drift(t0, y)
    g0dW = _apply_noise(diffusion(t0, y), dW, noise_type)
    y_pred = tree_map(lambda y_, f_, n_: y_ + dt * f_ + n_, y, f0, g0dW)
    f1 = drift(t1, y_pred)
    g1dW = _apply_noise(diffusion(t1, y_pred), dW, noise_type)
    return tree_map(
        lambda y_, fa, fb, na, nb: y_ + dt * (fa + fb) / 2 + (na + nb) / 2,
        y, f0, f1, g0dW, g1dW)


SDE_METHODS: Dict[str, Callable] = {
    "euler_maruyama": _em_step,
    "milstein": _milstein_step,
    "heun": _heun_step,
    "reversible_heun": None,  # carries f and g, dispatched in sdeint()
}


def _apply_noise(g: Tree, dW: Tree, noise_type: str) -> Tree:
    """g · dW per leaf: elementwise for diagonal noise, a matvec over the
    trailing noise axis for general noise."""
    if noise_type == "diagonal":
        return tree_map(lambda g_, w_: g_ * w_.to(g_.dtype), g, dW)
    return tree_map(
        lambda g_, w_: torch.einsum("...dm,...m->...d", g_, w_.to(g_.dtype)),
        g, dW)


def _noise_template(y0: Tree, g0: Tree, noise_type: str) -> Tree:
    """A tree shaped like one step's Brownian increment, of tensors on the
    meta device (shape and dtype only)."""
    if noise_type == "diagonal":
        return tree_map(lambda y_: torch.empty_like(y_, device="meta"), y0)

    def one(y_, g_):
        if g_.dim() != y_.dim() + 1 or tuple(g_.shape[:-1]) != tuple(y_.shape):
            raise ValueError(
                f"general-noise diffusion must map state (..., D) to "
                f"(..., D, M); got state {tuple(y_.shape)} vs g "
                f"{tuple(g_.shape)}")
        return torch.empty(tuple(y_.shape[:-1]) + (g_.shape[-1],),
                           dtype=y_.dtype, device="meta")

    return tree_map(one, y0, g0)


def _host_grid(ts, substeps: int):
    """(grid, out_index) on the host in float64: `substeps` equal internal
    steps an output interval; out_index[k] is the grid slot of ts[k]."""
    if torch.is_tensor(ts):
        if ts.requires_grad:
            raise ValueError("sdeint needs concrete ts (no gradient): the "
                             "grid is built on the host")
        ts = ts.detach().cpu().numpy()
    ts = np.asarray(ts, dtype=np.float64)
    if ts.ndim != 1 or ts.shape[0] < 2:
        raise ValueError(f"ts must be 1-D with >= 2 entries, got {ts.shape}")
    if not np.all(np.diff(ts) > 0):
        raise ValueError("sdeint needs strictly increasing ts (SDE paths "
                         "have no time-reversal trick)")
    if substeps < 1:
        raise ValueError(f"substeps must be >= 1, got {substeps}")
    pieces = [np.asarray([ts[0]])]
    for a, b in zip(ts[:-1], ts[1:]):
        pieces.append(np.linspace(a, b, substeps + 1)[1:])
    grid = np.concatenate(pieces)
    out_index = np.arange(ts.shape[0]) * substeps
    return grid, out_index


def _check_method(method: str, noise_type: str) -> None:
    if method not in SDE_METHODS:
        raise ValueError(
            f"unknown SDE method {method!r}; available: {sorted(SDE_METHODS)}")
    _check_noise_type(noise_type)
    if method == "milstein" and noise_type != "diagonal":
        raise ValueError(
            "milstein supports noise_type='diagonal' only (general noise "
            "needs Levy-area simulation)")


def _check_noise_type(noise_type: str) -> None:
    if noise_type not in ("diagonal", "general"):
        raise ValueError(f"unknown noise_type {noise_type!r}")


def _increments(tmpl: Tree, dW_user, generator, grid: np.ndarray, device,
                name: str) -> Tree:
    """The (n_steps, *increment) increments: `dW_user` checked against the
    template, or drawn from `generator` with variance dt of each step."""
    n_steps = grid.shape[0] - 1
    if dW_user is not None:
        for dw, w in zip(tree_leaves(dW_user), tree_leaves(tmpl)):
            if tuple(dw.shape) != (n_steps,) + tuple(w.shape):
                raise ValueError(
                    f"dW leaf shape {tuple(dw.shape)} != (n_steps={n_steps}, "
                    f"*increment {tuple(w.shape)})")
        return dW_user
    if generator is None:
        raise ValueError(f"{name} needs `generator` (or options={{'dW': "
                         "...}})")
    sqrt_dt = np.sqrt(np.diff(grid))

    def draw(w):
        scale = torch.as_tensor(sqrt_dt, dtype=w.dtype, device=device)
        z = torch.randn((n_steps,) + tuple(w.shape), generator=generator,
                        dtype=w.dtype, device=device)
        return z * scale.reshape((n_steps,) + (1,) * w.dim())

    return tree_map(draw, tmpl)


def _grid_tensors(grid: np.ndarray, device):
    """The grid's times as 0-dim float64 tensors on `device`, and each
    step's dt as a Python float."""
    g = torch.as_tensor(grid, dtype=torch.float64, device=device)
    return [g[i] for i in range(grid.shape[0])], np.diff(grid).tolist()


def _stack_outputs(outs):
    return tree_map(lambda *leaves: torch.stack(leaves), *outs)


def sdeint(drift: Callable, diffusion: Callable, y0: Tree, ts,
           generator: Optional[torch.Generator] = None,
           method: str = "euler_maruyama", noise_type: str = "diagonal",
           options: Optional[Dict[str, Any]] = None) -> Tree:
    """Integrate dy = drift dt + diffusion dW from y(ts[0]) = y0, returning
    the path at `ts` stacked on a new leading axis (odeint's contract).

    options:
      substeps (int): internal steps an output interval (default 1).
      dW: tree of pre-drawn Brownian increments, each leaf stacked to
          (n_steps, *increment.shape) with n_steps = (len(ts)-1)*substeps;
          `generator` may then be None.  Increments must have variance dt
          of the internal grid.
      checkpoint (bool): recompute each step in the backward pass
          (`torch.utils.checkpoint`): the stored activations drop to the
          per-step states.
    """
    options = dict(options or {})
    substeps = int(options.pop("substeps", 1))
    dW_user = options.pop("dW", None)
    use_ckpt = bool(options.pop("checkpoint", False))
    if options:
        raise ValueError(f"unknown sdeint options: {sorted(options)}")
    _check_method(method, noise_type)
    grid, out_index = _host_grid(ts, substeps)
    device = tree_leaves(y0)[0].device
    times, dts = _grid_tensors(grid, device)
    tmpl = _noise_template(y0, diffusion(times[0], y0), noise_type)
    dW = _increments(tmpl, dW_user, generator, grid, device, "sdeint")
    dW_leaves = tree_leaves(dW)
    outputs = set(out_index.tolist())

    def increment(n):
        return tree_unflatten(dW, [w[n] for w in dW_leaves])

    if method == "reversible_heun":
        def body(y, yh, f, g, t1, dt, dw):
            gdW = _apply_noise(g, dw, noise_type)
            yh1 = tree_map(lambda y_, yh_, f_, n_: 2.0 * y_ - yh_ + dt * f_
                           + n_, y, yh, f, gdW)
            f1 = drift(t1, yh1)
            g1 = diffusion(t1, yh1)
            g1dW = _apply_noise(g1, dw, noise_type)
            y1 = tree_map(lambda y_, fa, fb, na, nb:
                          y_ + dt * (fa + fb) / 2 + (na + nb) / 2,
                          y, f, f1, gdW, g1dW)
            return y1, yh1, f1, g1

        carry = (y0, y0, drift(times[0], y0), diffusion(times[0], y0))
        outs = [y0]
        for n, dt in enumerate(dts):
            args = carry + (times[n + 1], dt, increment(n))
            carry = (_checkpointed(body, *args) if use_ckpt
                     else body(*args))
            if n + 1 in outputs:
                outs.append(carry[0])
        return _stack_outputs(outs)

    step = SDE_METHODS[method]

    def body(y, t0, t1, dt, dw):
        return step(drift, diffusion, noise_type, t0, t1, dt, y, dw)

    y, outs = y0, [y0]
    for n, dt in enumerate(dts):
        args = (y, times[n], times[n + 1], dt, increment(n))
        y = _checkpointed(body, *args) if use_ckpt else body(*args)
        if n + 1 in outputs:
            outs.append(y)
    return _stack_outputs(outs)


def _checkpointed(body, *args):
    return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False)
