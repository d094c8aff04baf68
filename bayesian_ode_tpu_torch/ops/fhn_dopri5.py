"""FitzHugh-Nagumo parameter inference on the public fused engine.

Counterpart of `bayesian_ode_tpu/ops/fhn_dopri5.py`: the mechanistic FHN
field of `models/fhn_inference.py` with per-chain theta = (a, b, c),

    V' = c (V - V^3/3 + R),   R' = -(V - a + b R) / c,

registered with the public fused engine (`ops/fused_field.py`).  The
kernels are the engine's templates over `csrc/fhn_field.cuh`: the
forward over `FHNPoint` (one trajectory point a thread, N lanes a chain;
past 32 points a chain over `FHNDopri5`), the replay backward over
`FHNDopri5` (one chain a thread); theta in registers.  The field
multiplies by inv_c = 1/c, as the TPU kernel does; the host reference
used for the Hairer start step divides by c, as the JAX package's does.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from .fused_field import (
    FusedField,
    fused_dopri5_stats,
    fused_dopri5_trajectory,
)

_THIRD = 1.0 / 3.0


def _theta(w):
    a, b, c = (x[:, None] for x in w)                   # (C, 1) each
    return a, b, c, 1.0 / c


def _make_rhs(w):
    a, b, c, inv_c = _theta(w)

    def rhs(y):
        x, r = y[..., 0], y[..., 1]
        s = x - x * x * x * _THIRD + r                  # V' = c s
        q = x - a + b * r                               # R' = -q / c
        return torch.stack([c * s, -q * inv_c], dim=-1)

    return rhs


def _make_rhs_vjp(w):
    """(y, cot) -> (ybar, (ga, gb, gc)), all per chain:
    d fy/da = 1/c, d fy/db = -R/c, d fy/dc = q/c^2, d fx/dc = s;
    d fx/dV = c (1 - V^2), d fx/dR = c, d fy/dV = -1/c, d fy/dR = -b/c."""
    a, b, c, inv_c = _theta(w)

    def rhs_vjp(y, cot):
        x, r = y[..., 0], y[..., 1]
        cx, cy = cot[..., 0], cot[..., 1]
        s = x - x * x * x * _THIRD + r
        q = x - a + b * r
        ga = (cy * inv_c).sum(dim=1)
        gb = -(cy * r * inv_c).sum(dim=1)
        gc = (cx * s + cy * q * inv_c * inv_c).sum(dim=1)
        xb = cx * c * (1.0 - x * x) - cy * inv_c
        yb = cx * c - cy * b * inv_c
        return torch.stack([xb, yb], dim=-1), (ga, gb, gc)

    return rhs_vjp


def _rhs_ref(w, pts):
    a, b, c = (x[:, None, None] for x in w)             # (C, 1, 1)
    x, y = pts[..., 0:1], pts[..., 1:2]
    return torch.cat([c * (x - x * x * x * _THIRD + y),
                      -(x - a + b * y) / c], dim=-1)


def _shapes(w):
    C = w[0].shape[0]
    return (C,), (C,), (C,)


@lru_cache(maxsize=None)
def fhn_field() -> FusedField:
    """The FitzHugh-Nagumo theta-field registered with the fused engine
    (its library is keyed by N alone)."""
    return FusedField(name="fhn", n_wbar=3, make_rhs=_make_rhs,
                      make_rhs_vjp=_make_rhs_vjp, rhs_ref=_rhs_ref,
                      shapes=_shapes)


def _weights(theta):
    return theta["a"], theta["b"], theta["c"]


def fhn_dopri5_trajectory(theta, x0, ts, rtol=1e-7, atol=1e-9, **opts):
    """Adaptive trajectories (T, C, N, 2) of the per-chain FHN field,
    differentiable with respect to theta {'a', 'b', 'c'} of shape (C,) and
    x0 (N, 2).  `opts` as `fused_dopri5_trajectory`."""
    return fused_dopri5_trajectory(fhn_field(), _weights(theta), x0, ts,
                                   rtol=rtol, atol=atol, **opts)


def fhn_dopri5_solve_stats(theta, x0, ts, **opts):
    """(trajectory, stats): `n_iterations` is each chain's accepted-step
    count, the quantity `store_steps` must cover."""
    return fused_dopri5_stats(fhn_field(), _weights(theta), x0, ts, **opts)


def make_fused_fhn_potential_dopri5(x0, ts, X, noise=0.1,
                                    prior_loc=(0.0, 0.0, 3.0),
                                    prior_scale=(1.0, 1.0, 1.0),
                                    rtol=1e-7, atol=1e-9, max_steps=100_000,
                                    store_steps=128, controller="i"):
    """FHN posterior potential of a chain batch: Gaussian likelihood at
    known observation noise and independent Gaussian priors on (a, b, c).
    X is (N, T, 2).  Returns potential_batch(theta) -> (C,) in float32.
    c must stay positive (the field divides by it)."""
    inv_two_noise_sq = 0.5 / float(noise) ** 2

    def potential_batch(theta):
        traj = fhn_dopri5_trajectory(
            theta, x0, ts, rtol=rtol, atol=atol, max_steps=max_steps,
            store_steps=store_steps, controller=controller)
        dev = traj.device
        Xd = torch.as_tensor(X).to(device=dev, dtype=traj.dtype)
        xode = traj.permute(1, 2, 0, 3)                     # (C, N, T, 2)
        sse = ((Xd[None] - xode) ** 2).sum(dim=(1, 2, 3))
        th = torch.stack([theta["a"], theta["b"], theta["c"]],
                         dim=-1).to(torch.float32)
        loc = torch.as_tensor(prior_loc, dtype=th.dtype, device=dev)
        scale = torch.as_tensor(prior_scale, dtype=th.dtype, device=dev)
        prior = 0.5 * (((th - loc) / scale) ** 2).sum(dim=-1)
        return inv_two_noise_sq * sse + prior

    return potential_batch
