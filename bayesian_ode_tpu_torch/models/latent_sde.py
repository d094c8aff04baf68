"""Latent SDE: a variational stochastic differential equation over a
latent state, trained by the pathwise (Girsanov) ELBO.

Counterpart of `bayesian_ode_tpu/models/latent_sde.py` (Li et al. 2020,
arXiv:2001.01328):

    prior:      dz = f_theta(t, z) dt           + g_theta(t) dW
    posterior:  dz = h_phi(t, z, ctx(t)) dt     + g_theta(t) dW

with a shared diffusion, and

    ELBO = E_q[ sum_k log p(x_k | z_k) - int_0^T (1/2)|u|^2 dt ]
           - KL(q(z0) || p(z0)),       u = (h - f) / g.

The KL integral rides the path's solve: the state is {"z": z, "kl": kl}
through `sde.sdeint`, with drift {"z": h, "kl": |u|^2/2} and diffusion
{"z": g, "kl": 0}, so one fixed-grid Euler-Maruyama solve gives the
trajectory and the discretized KL, and autograd through the loop gives
the discrete adjoint of the discretized objective.

The posterior drift reads a reverse-time GRU context, piecewise constant
between observation times: the interval [ts[k], ts[k+1]) reads ctx[:, k],
found by `searchsorted` of the step's time in ts, both in float64 (the
grid points at the observation times equal ts[k] exactly, so they read
their own interval's context).  The GRU keeps the JAX package's gate
layout (input and hidden products each split r, z, n), not `nn.GRU`'s.

`make_loss`'s -ELBO draws z0's noise and the path's increments from a
`torch.Generator`; `_elbo` is the same loss on given (eps, dW).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..sde.sdeint import _host_grid, _increments, sdeint
from .latent_ode import (_linear, _linear_init, log_normal_pdf, normal_kl,
                         params_from_numpy)

__all__ = [
    "init_params",
    "encode",
    "make_loss",
    "params_from_numpy",
    "sample_prior",
    "sample_posterior",
]


def _mlp_init(generator, sizes, dtype, device):
    return [_linear_init(generator, a, b, dtype, device)
            for a, b in zip(sizes[:-1], sizes[1:])]


def _mlp(params, x, act=F.softplus):
    for p in params[:-1]:
        x = act(_linear(p, x))
    return _linear(params[-1], x)


def init_params(generator: torch.Generator, latent_dim=4, obs_dim=2,
                ctx_dim=16, nhidden=32, rnn_nhidden=32, dtype=torch.float32,
                device=None):
    """Parameter tree: prior drift f, posterior drift h (takes ctx),
    per-dimension log-diffusion, reverse GRU encoder (context + q(z0)),
    decoder, and a learnable standard-normal p(z0)."""
    def lin(a, b):
        return _linear_init(generator, a, b, dtype, device)

    def full(value):
        return torch.full((latent_dim,), value, dtype=dtype, device=device)

    return {
        "f": _mlp_init(generator, [latent_dim + 1, nhidden, latent_dim],
                       dtype, device),
        "h": _mlp_init(generator,
                       [latent_dim + 1 + ctx_dim, nhidden, latent_dim],
                       dtype, device),
        "logsd": full(-1.0),
        "gru": {"ih": lin(obs_dim, 3 * rnn_nhidden),
                "hh": lin(rnn_nhidden, 3 * rnn_nhidden)},
        "ctx_proj": lin(rnn_nhidden, ctx_dim),
        "qz0": lin(rnn_nhidden, 2 * latent_dim),
        "dec": _mlp_init(generator, [latent_dim, nhidden, obs_dim], dtype,
                         device),
        "pz0_mean": full(0.0),
        "pz0_logvar": full(0.0),
    }


def _gru_cell(p, h, x):
    i_r, i_z, i_n = torch.chunk(_linear(p["ih"], x), 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(_linear(p["hh"], h), 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def encode(params, xs):
    """Reverse-time GRU over observations (B, T, obs_dim) ->
    (ctx (B, T, ctx_dim), qz0_mean (B, L), qz0_logvar (B, L)).

    ctx[:, k] summarizes observations k..T-1, the filtering context the
    posterior drift reads on [t_k, t_{k+1})."""
    B, T = xs.shape[0], xs.shape[1]
    d_h = params["gru"]["hh"]["w"].shape[0]
    h = torch.zeros((B, d_h), dtype=xs.dtype, device=xs.device)
    hs = [None] * T
    for t in reversed(range(T)):
        h = _gru_cell(params["gru"], h, xs[:, t])
        hs[t] = h
    ctx = _linear(params["ctx_proj"], torch.stack(hs, dim=1))  # (B, T, C)
    out = _linear(params["qz0"], h)                             # (B, 2L)
    L = out.shape[-1] // 2
    return ctx, out[:, :L], out[:, L:]


def _time_column(t, z):
    return t.to(z.dtype).expand(z.shape[:-1] + (1,))


def _prior_drift(params, t, z):
    return _mlp(params["f"], torch.cat([z, _time_column(t, z)], dim=-1))


def _posterior_drift(params, t, z, c):
    return _mlp(params["h"], torch.cat([z, _time_column(t, z), c], dim=-1))


def _diffusion(params, z):
    return torch.exp(params["logsd"]).to(z.dtype).expand(z.shape)


def _context_at(ts, ctx, t):
    """ctx[:, k] with k = clip(searchsorted(ts, t, side='right') - 1),
    on the card without a host read."""
    k = torch.clamp(torch.searchsorted(ts, t.reshape(1), right=True) - 1,
                    0, ts.shape[0] - 1)
    return ctx.index_select(1, k)[:, 0]


def _host_times(ts):
    if torch.is_tensor(ts):
        return ts.detach().cpu().numpy().astype(np.float64)
    return np.asarray(ts, dtype=np.float64)


def _elbo(ts, xs, noise_std: float, substeps: int,
          kl_weight: float) -> Callable:
    """-ELBO(params, eps, dW) on given noise: eps (B, L) for z0 and dW
    {"kl": (n_steps, B), "z": (n_steps, B, L)} for the path."""
    ts_host = _host_times(ts)
    ts64 = torch.as_tensor(ts_host, dtype=torch.float64, device=xs.device)
    noise_logvar = 2.0 * np.log(noise_std)
    B = xs.shape[0]

    def loss(params, eps, dW):
        ctx, qm, qlv = encode(params, xs)
        z0 = qm + eps * torch.exp(0.5 * qlv)

        def drift(t, state):
            z = state["z"]
            h = _posterior_drift(params, t, z, _context_at(ts64, ctx, t))
            f = _prior_drift(params, t, z)
            u = (h - f) / _diffusion(params, z)
            return {"z": h, "kl": 0.5 * (u * u).sum(dim=-1)}

        def diffusion(t, state):
            return {"z": _diffusion(params, state["z"]),
                    "kl": torch.zeros_like(state["kl"])}

        state0 = {"z": z0, "kl": torch.zeros((B,), dtype=z0.dtype,
                                             device=z0.device)}
        path = sdeint(drift, diffusion, state0, ts_host,
                      options={"substeps": substeps, "dW": dW})
        zs = path["z"].movedim(0, 1)                 # (B, T, L)
        kl_path = path["kl"][-1]                     # (B,)
        pred_x = _mlp(params["dec"], zs)
        logpx = log_normal_pdf(xs, pred_x, noise_logvar).sum(dim=(-2, -1))
        kl_z0 = normal_kl(qm, qlv, params["pz0_mean"],
                          params["pz0_logvar"]).sum(dim=-1)
        return (-logpx + kl_weight * (kl_z0 + kl_path)).mean()

    return loss


def make_loss(ts, xs, noise_std: float = 0.1, substeps: int = 2,
              kl_weight: float = 1.0) -> Callable:
    """-ELBO(params, generator) for observations xs (B, T, obs_dim) at
    concrete times ts (T,): z0's noise and the path's increments drawn
    from `generator` (on xs's device) in xs's dtype.

    One Euler-Maruyama solve of the augmented posterior SDE a call (the
    batch on the state's leading axis), the Girsanov KL in the "kl"
    channel, a Gaussian observation likelihood at the output times."""
    body = _elbo(ts, xs, noise_std, substeps, kl_weight)
    grid, _ = _host_grid(_host_times(ts), substeps)
    B = xs.shape[0]

    def loss(params, generator: torch.Generator):
        L = params["pz0_mean"].shape[0]
        eps = torch.randn((B, L), generator=generator, dtype=xs.dtype,
                          device=xs.device)
        meta = {"kl": torch.empty((B,), dtype=xs.dtype, device="meta"),
                "z": torch.empty((B, L), dtype=xs.dtype, device="meta")}
        dW = _increments(meta, None, generator, grid, xs.device,
                         "latent_sde.make_loss")
        return body(params, eps, dW)

    return loss


def sample_prior(params, generator: torch.Generator, ts, num_samples: int,
                 substeps: int = 2):
    """(num_samples, T, obs_dim) decoded draws from the prior SDE, the
    generative model after training."""
    mean = params["pz0_mean"]
    z0 = mean + torch.exp(0.5 * params["pz0_logvar"]) * torch.randn(
        (num_samples, mean.shape[0]), generator=generator, dtype=mean.dtype,
        device=mean.device)
    zs = sdeint(lambda t, z: _prior_drift(params, t, z),
                lambda t, z: _diffusion(params, z), z0, _host_times(ts),
                generator, options={"substeps": substeps})
    return _mlp(params["dec"], zs).movedim(0, 1)


def sample_posterior(params, generator: torch.Generator, ts, xs,
                     substeps: int = 2):
    """Decoded posterior-path draws conditioned on observations xs
    (B, T, obs_dim): one posterior-SDE sample a batch row."""
    ts_host = _host_times(ts)
    ts64 = torch.as_tensor(ts_host, dtype=torch.float64, device=xs.device)
    ctx, qm, qlv = encode(params, xs)
    z0 = qm + torch.exp(0.5 * qlv) * torch.randn(
        qm.shape, generator=generator, dtype=qm.dtype, device=qm.device)

    def drift(t, z):
        return _posterior_drift(params, t, z, _context_at(ts64, ctx, t))

    zs = sdeint(drift, lambda t, z: _diffusion(params, z), z0, ts_host,
                generator, options={"substeps": substeps})
    return _mlp(params["dec"], zs).movedim(0, 1)
