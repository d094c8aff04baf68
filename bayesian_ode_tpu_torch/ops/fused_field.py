"""Public fused adaptive engine: any registered vector field, one forward
kernel and one backward kernel.

Counterpart of `bayesian_ode_tpu/ops/fused_field.py`.  A field is
registered once as a `FusedField`:

    field = FusedField(name=..., n_wbar=..., make_rhs=..., make_rhs_vjp=...,
                       rhs_ref=..., shapes=..., width=..., scalars=...)
    ys = fused_dopri5_trajectory(field, w, x0, ts, rtol=1e-7, ...)

`w` is a tuple of float32 weight blocks: per-chain blocks with a leading
chain axis C first, then any blocks shared by all chains (the GP field's
inducing grid), which get zero cotangents.  States are (C, N, 2): N phase
points of a 2-D system per chain, from the shared x0 (N, 2).  CUDA tensors
launch the field's kernels (`csrc/dopri5_kernels.cuh` over the field's
functor: K2 forward, K3 backward); CPU tensors take their plain versions
over the field's batched torch `rhs` and `rhs_vjp`.

The tableau is `method="dopri5"` or `"tsit5"`: any 7-stage FSAL pair with
quartic dense output.  Gradients are the frozen-step-mesh discrete adjoint
at tolerance (`ops/gp_dopri5_grad.py` says what that means).  The Hairer
start step is computed on the host from the field's `rhs_ref` (on the
card in blocks of a fixed number of chains: `_start`).

The TPU engine recorded per lockstep tile of 128 chains; the port records
per chain, so `stats["n_iterations"]` is each chain's own accepted-step
count, which is what `store_steps` must cover.  The forward raises when a
chain overflows its records.  The JAX engine's tile and VMEM sizing and
its chain padding have no counterpart: the kernels take any C.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..models.kernel_regression import full_f32_matmul
from . import fused_adaptive as fa
from .gp_dopri5 import _check_controller, _hairer_initial_step


class FusedField(NamedTuple):
    """A vector field registered with the fused adaptive engine.

    name          its kernel library "{name}_dopri5" (`ops/_build.py`) and
                  the prefix of its launch counters;
    n_wbar        the leading weight blocks that get cotangents;
    make_rhs      w -> rhs(y (C, N, 2)) -> (C, N, 2), the plain field in
                  the kernel's operation order where it matters;
    make_rhs_vjp  w -> rhs_vjp(y, cot) -> (ybar, the n_wbar cotangents);
    rhs_ref       (w, pts (C, N, 2)) -> (C, N, 2), the host reference used
                  for the Hairer start step;
    shapes        w -> the shapes the kernels take for the blocks of w;
    width         w -> the library's second shape key (M or H), or None
                  when the library is keyed by N alone;
    scalars       the field's float arguments after its weights.
    """
    name: str
    n_wbar: int
    make_rhs: Callable
    make_rhs_vjp: Callable
    rhs_ref: Callable
    shapes: Callable
    width: Optional[Callable] = None
    scalars: Tuple[float, ...] = ()

    def library(self, w, N: int):
        """(family, shape) of the kernel library for weights w, N points."""
        shape = (N,) if self.width is None else (N, int(self.width(w)))
        return f"{self.name}_dopri5", shape


def _check_method(method: str) -> None:
    if method not in fa.TABLEAUS:
        raise ValueError(f"unknown fused method {method!r}; expected one "
                         f"of {sorted(fa.TABLEAUS)}")


def _prepare(w, x0, ts):
    """Float32, contiguous, on the weights' device."""
    w = tuple(x.to(torch.float32).contiguous() for x in w)
    dev = w[0].device
    if w[0].is_cuda:
        full_f32_matmul()
    return (w, x0.to(device=dev, dtype=torch.float32).contiguous(),
            torch.as_tensor(ts, device=dev).to(torch.float32).contiguous())


# chains a block of the start's computation on the card (a batch of the
# main path's 10,112 chains, or a shard of it, is one block)
START_BLOCK = 16384


def _start(field, w, x0, rtol, atol, block=None):
    """The (C, N, 2) start states and the Hairer initial slope and step.

    The slope and step are computed in blocks of `block` chains (on the
    card START_BLOCK, on the CPU the whole batch at once), the last block
    padded with copies of the last chain: cuBLAS picks its GEMM by the
    shape, so a chain's start (and so its whole solve) then does not
    depend on how many chains are solved with it, and a solve split over
    shards equals the unsplit one bit for bit."""
    C = w[0].shape[0]
    x0b = x0.expand(C, *x0.shape[-2:])
    if block is None:
        if not x0b.is_cuda:
            f0, dt0 = _hairer_initial_step(lambda p: field.rhs_ref(w, p),
                                           x0b, rtol, atol)
            return x0b, f0, dt0
        block = START_BLOCK
    f0s, dt0s = [], []
    for lo in range(0, C, block):
        n = min(block, C - lo)

        def rows(x):
            x = x[lo:lo + n]
            return torch.cat([x, x[-1:].expand(block - n, *x.shape[1:])])

        wb = tuple(rows(x) if i < field.n_wbar else x
                   for i, x in enumerate(w))
        f0, dt0 = _hairer_initial_step(lambda p: field.rhs_ref(wb, p),
                                       rows(x0b), rtol, atol)
        f0s.append(f0[:n])
        dt0s.append(dt0[:n])
    if len(f0s) == 1:
        return x0b, f0s[0], dt0s[0]
    return x0b, torch.cat(f0s), torch.cat(dt0s)


class _Trajectory(torch.autograd.Function):
    @staticmethod
    def forward(ctx, field, opts, x0, ts, *w):
        (rtol, atol, safety, ifactor, dfactor, max_steps, store_steps,
         controller, method) = opts
        x0b, f0, dt0 = _start(field, w, x0, rtol, atol)
        ys, _, nacc, _, _, rec = fa.fwd(
            field, w, x0b, f0, dt0, ts, rtol, atol, safety, ifactor,
            dfactor, max_steps, controller, record=True,
            store_steps=store_steps, method=method)
        ctx.save_for_backward(ts, rec, nacc, *w)
        ctx.field, ctx.method = field, method
        return ys

    @staticmethod
    def backward(ctx, g):
        ts, rec, nacc, *w = ctx.saved_tensors
        field = ctx.field
        wbar, lbar = fa.bwd(field, tuple(w), ts, rec, nacc, g, ctx.method)
        # x0 is shared by the chains; row 0 of the trajectory is x0 itself
        x0bar = lbar.sum(dim=0) + g[0].sum(dim=0)
        shared = tuple(torch.zeros_like(x) for x in w[field.n_wbar:])
        return (None, None, x0bar, None) + tuple(wbar) + shared


def _opts(rtol, atol, safety, ifactor, dfactor, max_steps, store_steps,
          controller, method):
    _check_controller(controller)
    _check_method(method)
    return (float(rtol), float(atol), float(safety), float(ifactor),
            float(dfactor), int(max_steps), int(store_steps), controller,
            method)


def fused_dopri5_trajectory(field: FusedField, w, x0, ts, rtol=1e-7,
                            atol=1e-9, safety=0.9, ifactor=10.0,
                            dfactor=0.2, max_steps=100_000, store_steps=128,
                            controller="i", method="dopri5"):
    """Adaptive trajectories of a registered field, differentiable with
    respect to the weight blocks `w` and x0 through the hand-written
    discrete adjoint.

    x0 (N, 2) shared; ts (T,) increasing.  Returns (T, C, N, 2) float32.
    Gradients need every chain's accepted steps to fit `store_steps`; the
    forward raises otherwise (size it with `fused_dopri5_stats`).
    """
    opts = _opts(rtol, atol, safety, ifactor, dfactor, max_steps,
                 store_steps, controller, method)
    w, x0, ts = _prepare(w, x0, ts)
    return _Trajectory.apply(field, opts, x0, ts, *w)


def _stats(field, w, x0, ts, opts, plain):
    (rtol, atol, safety, ifactor, dfactor, max_steps, _, controller,
     method) = opts
    w, x0, ts = _prepare(w, x0, ts)
    with torch.no_grad():
        x0b, f0, dt0 = _start(field, w, x0, rtol, atol)
        args = (x0b, f0, dt0, ts, rtol, atol, safety, ifactor, dfactor,
                max_steps, controller)
        if plain:
            out = fa.fwd_plain(field.make_rhs(w), *args,
                               tableau=fa.TABLEAUS[method])
        else:
            out = fa.fwd(field, w, *args, record=False, method=method)
    ys, nfe, nacc, nrej, t1 = out[:5]
    return ys, {"nfe": nfe, "n_accepted": nacc, "n_rejected": nrej,
                "n_iterations": nacc,
                "reached_final_time": bool((t1 >= ts[-1]).all())}


def fused_dopri5_stats(field: FusedField, w, x0, ts, rtol=1e-7, atol=1e-9,
                       safety=0.9, ifactor=10.0, dfactor=0.2,
                       max_steps=100_000, store_steps=128, controller="i",
                       method="dopri5"):
    """Forward solve without records, returning (trajectory, stats): the
    per-chain int32 `nfe`, `n_accepted`, `n_rejected` and `n_iterations`
    (each chain's accepted steps, the count `store_steps` must cover) and
    the bool `reached_final_time`.  Output times a chain never reached
    (budget exhaustion) hold its final state."""
    return _stats(field, w, x0, ts,
                  _opts(rtol, atol, safety, ifactor, dfactor, max_steps,
                        store_steps, controller, method), plain=False)


def fused_dopri5_stats_plain(field: FusedField, w, x0, ts, rtol=1e-7,
                             atol=1e-9, safety=0.9, ifactor=10.0,
                             dfactor=0.2, max_steps=100_000, controller="i",
                             method="dopri5"):
    """The plain version of `fused_dopri5_stats`, on any device: the
    chains advance in masked lockstep."""
    return _stats(field, w, x0, ts,
                  _opts(rtol, atol, safety, ifactor, dfactor, max_steps, 0,
                        controller, method), plain=True)


def fused_dopri5_trajectory_plain(field: FusedField, w, x0, ts, rtol=1e-7,
                                  atol=1e-9, safety=0.9, ifactor=10.0,
                                  dfactor=0.2, max_steps=100_000,
                                  controller="i", method="dopri5"):
    """The trajectories of the plain forward, on any device, with
    gradients by autograd through it (step sizes detached: the
    frozen-mesh gradient computed a second, independent way)."""
    _opts(rtol, atol, safety, ifactor, dfactor, max_steps, 0, controller,
          method)
    w, x0, ts = _prepare(w, x0, ts)
    x0b, f0, dt0 = _start(field, w, x0, rtol, atol)
    return fa.fwd_plain(field.make_rhs(w), x0b, f0, dt0, ts, rtol, atol,
                        safety, ifactor, dfactor, max_steps, controller,
                        tableau=fa.TABLEAUS[method])[0]
