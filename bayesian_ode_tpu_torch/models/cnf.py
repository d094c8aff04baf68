"""Continuous normalizing flows (FFJORD) on the port's odeint.

Counterpart of `bayesian_ode_tpu/models/cnf.py` (Chen et al. 2018 §4;
Grathwohl et al. 2019):

- the whole batch integrates as one augmented ODE (batch on a leading
  axis; an adaptive solver sees the joint error norm, as FFJORD's batched
  solves);
- the instantaneous change of variables d log p(z(t))/dt = -tr(∂f/∂z)
  takes its trace exactly (`trace="exact"`: a Jacobian a row by forward
  mode, `torch.func.vmap` of `jacfwd`) or by the Hutchinson estimator
  (`trace="hutchinson"`: one VJP a row against a Rademacher probe held
  fixed for the whole solve, `torch.func.vmap` of `vjp`); both stay
  differentiable, so training backpropagates through the trace;
- gradients flow through whatever `odeint_fn` supports (autograd through
  the fixed-grid `rk4` loop, or `odeint_adjoint`).

Conventions: the base distribution (standard normal) lives at `t0`, the
data at `t1`.  `cnf_log_prob` integrates data -> base (t1 down to t0, a
decreasing two-point grid); `sample_cnf` integrates base -> data.

Randomness comes from a `torch.Generator` where the JAX package takes a
key; `make_nll` and `make_potential` draw their Hutchinson probes once, as
the JAX package's fixed key gives the same probes at every call.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional, Sequence

import torch

from ..ode import odeint
from ..utils.pytree import tree_sum_squares
from .latent_ode import params_from_numpy
from .mlp import init_mlp

__all__ = [
    "augmented_field",
    "cnf_field",
    "cnf_log_prob",
    "init_cnf_mlp",
    "make_nll",
    "make_potential",
    "params_from_numpy",
    "rademacher",
    "sample_cnf",
    "standard_normal_logpdf",
]


def init_cnf_mlp(generator: torch.Generator, dim: int,
                 hidden: Sequence[int] = (64, 64), dtype=torch.float32,
                 device=None):
    """Params for the time-concat MLP field `cnf_field`: layers
    (dim+1, *hidden, dim) with the package MLP init (uniform(-0.5, 0.5)
    weights, zero biases), the last layer zeroed so the initial flow is
    the identity."""
    params = init_mlp(generator, (dim + 1, *hidden, dim), dtype=dtype,
                      device=device)
    params[-1] = {k: torch.zeros_like(v) for k, v in params[-1].items()}
    return params


def cnf_field(params, t, x, precision=None):
    """f(t, x) for x (..., D): tanh MLP on [x, t] (time concatenated as a
    trailing feature).  `precision` is accepted for the JAX signature and
    ignored (full float32 products on the card)."""
    tt = torch.as_tensor(t, dtype=x.dtype, device=x.device).expand(
        x.shape[:-1] + (1,))
    h = torch.cat([x, tt], dim=-1)
    for layer in params[:-1]:
        h = torch.tanh(torch.matmul(h, layer["w"]) + layer["b"])
    last = params[-1]
    return torch.matmul(h, last["w"]) + last["b"]


def augmented_field(field: Callable, trace: str = "exact",
                    probes: Optional[torch.Tensor] = None) -> Callable:
    """The FFJORD augmented dynamics over state (z (B, D), l (B,)):

        dz/dt = f(t, z),   dl/dt = tr(∂f/∂z)   (per sample)

    so l accumulates the signed log-density change whichever way time
    runs.  `probes` (B, D) is required for trace="hutchinson"."""
    if trace == "hutchinson" and probes is None:
        raise ValueError("trace='hutchinson' needs fixed probes (B, D); "
                         "draw them once per solve (rademacher)")
    if trace not in ("exact", "hutchinson"):
        raise ValueError(f"unknown trace estimator: {trace!r}")

    def aug(t, state):
        z, _ = state

        def f_row(zi):
            return field(t, zi)

        dz = field(t, z)
        if trace == "exact":
            jac = torch.func.vmap(torch.func.jacfwd(f_row))(z)   # (B, D, D)
            tr = torch.diagonal(jac, dim1=-2, dim2=-1).sum(-1)
        else:
            def one(zi, vi):
                _, vjp = torch.func.vjp(f_row, zi)
                return (vjp(vi)[0] * vi).sum()

            tr = torch.func.vmap(one)(z, probes)
        return dz, tr

    return aug


def standard_normal_logpdf(z: torch.Tensor) -> torch.Tensor:
    """log N(z; 0, I) summed over the trailing axis."""
    d = z.shape[-1]
    return -0.5 * (z * z).sum(-1) - 0.5 * d * math.log(2.0 * math.pi)


def rademacher(generator: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """iid +-1 entries with equal probability."""
    bits = torch.randint(0, 2, tuple(shape), generator=generator,
                         device=device)
    return (2 * bits - 1).to(dtype)


def _default_odeint():
    return partial(odeint, rtol=1e-5, atol=1e-7)


def _log_prob(field, x, t0, t1, odeint_fn, trace, probes, base_logpdf,
              return_z0):
    aug = augmented_field(field, trace, probes)
    ts = torch.tensor([t1, t0], dtype=torch.float64)
    zs, ls = odeint_fn(aug, (x, torch.zeros(x.shape[:-1], dtype=x.dtype,
                                            device=x.device)), ts)
    z0, l0 = zs[-1], ls[-1]
    logp = base_logpdf(z0) + l0
    return (logp, z0) if return_z0 else logp


def _probes(trace, generator, x):
    if trace != "hutchinson":
        return None
    if generator is None:
        raise ValueError("trace='hutchinson' needs a generator")
    return rademacher(generator, x.shape, x.dtype, x.device)


def cnf_log_prob(field: Callable, x: torch.Tensor, t0: float = 0.0,
                 t1: float = 1.0, odeint_fn: Optional[Callable] = None,
                 trace: str = "exact",
                 generator: Optional[torch.Generator] = None,
                 base_logpdf: Callable = standard_normal_logpdf,
                 return_z0: bool = False):
    """log p(x) under the CNF: integrate (z, l) from t1 (data) back to t0
    (base) and apply the instantaneous change of variables,

        log p(x) = base_logpdf(z(t0)) + l(t0),   l(t1) = 0, dl/dt = tr.

    x: (B, D).  `odeint_fn(func, y0, ts)` defaults to dopri5 at
    rtol=1e-5/atol=1e-7; pass partial(odeint, method="rk4",
    options={"step_size": h}) for fixed-grid backprop or odeint_adjoint
    for the continuous adjoint.  trace="hutchinson" draws one Rademacher
    probe a sample from `generator`."""
    odeint_fn = odeint_fn or _default_odeint()
    return _log_prob(field, x, t0, t1, odeint_fn, trace,
                     _probes(trace, generator, x), base_logpdf, return_z0)


def sample_cnf(field: Callable, generator: torch.Generator, num: int,
               dim: int, t0: float = 0.0, t1: float = 1.0,
               odeint_fn: Optional[Callable] = None,
               trace: Optional[str] = None,
               base_logpdf: Callable = standard_normal_logpdf,
               dtype=torch.float32, device=None):
    """Draw `num` samples: z0 ~ N(0, I) at t0 from `generator` (on
    `device`), integrated forward to t1.  trace=None skips the trace
    accumulation; trace="exact"/"hutchinson" also returns log p(x) of the
    draws, base_logpdf(z0) - l(t1)."""
    odeint_fn = odeint_fn or _default_odeint()
    z0 = torch.randn((num, dim), generator=generator, dtype=dtype,
                     device=device)
    ts = torch.tensor([t0, t1], dtype=torch.float64)
    if trace is None:
        return odeint_fn(lambda t, z: field(t, z), z0, ts)[-1]
    probes = _probes(trace, generator, z0)
    aug = augmented_field(field, trace, probes)
    zs, ls = odeint_fn(aug, (z0, torch.zeros(num, dtype=dtype,
                                             device=z0.device)), ts)
    return zs[-1], base_logpdf(z0) - ls[-1]


def make_nll(x: torch.Tensor, field_of_params: Callable = cnf_field,
             t0: float = 0.0, t1: float = 1.0,
             odeint_fn: Optional[Callable] = None, trace: str = "exact",
             generator: Optional[torch.Generator] = None) -> Callable:
    """nll(params) = -mean_i log p(x_i): the CNF maximum-likelihood
    objective, differentiable in params through `odeint_fn`.  Hutchinson
    probes are drawn once, here, and held for every call."""
    odeint_fn = odeint_fn or _default_odeint()
    probes = _probes(trace, generator, x)

    def nll(params):
        field = lambda t, z: field_of_params(params, t, z)  # noqa: E731
        return -_log_prob(field, x, t0, t1, odeint_fn, trace, probes,
                          standard_normal_logpdf, False).mean()

    return nll


def make_potential(x: torch.Tensor, field_of_params: Callable = cnf_field,
                   reg: float = 1e-2, t0: float = 0.0, t1: float = 1.0,
                   odeint_fn: Optional[Callable] = None,
                   trace: str = "exact",
                   generator: Optional[torch.Generator] = None) -> Callable:
    """Bayesian CNF potential: -sum_i log p(x_i | params)
    + reg * ||params||^2 (Gaussian weight prior), the samplers' one-chain
    potential contract.  Hutchinson probes are drawn once, here."""
    odeint_fn = odeint_fn or _default_odeint()
    probes = _probes(trace, generator, x)

    def potential(params):
        field = lambda t, z: field_of_params(params, t, z)  # noqa: E731
        ll = _log_prob(field, x, t0, t1, odeint_fn, trace, probes,
                       standard_normal_logpdf, False).sum()
        return -ll + reg * tree_sum_squares(params)

    return potential
