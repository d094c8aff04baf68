"""Latent ODE VAE over 2-D spirals.

Counterpart of `bayesian_ode_tpu/models/latent_ode.py` (reference:
neuralode_examples/latent_ode.py).  A recognition RNN reads the
observation sequence in reverse to q(z0); a 4-d latent ODE (ELU MLP) is
integrated over the sample times; a decoder maps back to observation
space; the loss is -ELBO = -log N(x | x_hat, sigma^2) + KL(q(z0) || N(0, I)).

Parameters are the JAX package's nested dicts of {'w': (d_in, d_out),
'b': (d_out,)} layers, as tensors; `params_from_numpy` carries the JAX
package's weights over.  `make_loss`'s -ELBO draws the reparameterization
noise from a `torch.Generator`; `_elbo` is the same loss on given noise.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.pytree import tree_map


def _linear_init(generator: torch.Generator, d_in, d_out,
                 dtype=torch.float32, device=None):
    # torch.nn.Linear's default: U(-1/sqrt(d_in), 1/sqrt(d_in))
    bound = 1.0 / math.sqrt(d_in)

    def u(shape):
        return (torch.rand(shape, generator=generator, dtype=dtype,
                           device=device) * 2.0 - 1.0) * bound

    return {"w": u((d_in, d_out)), "b": u((d_out,))}


def _linear(p, x):
    return torch.matmul(x, p["w"]) + p["b"]


def init_params(generator: torch.Generator, latent_dim=4, obs_dim=2,
                nhidden=20, rnn_nhidden=25, dtype=torch.float32,
                device=None):
    def lin(a, b):
        return _linear_init(generator, a, b, dtype, device)

    return {
        "func": {"fc1": lin(latent_dim, nhidden),
                 "fc2": lin(nhidden, nhidden),
                 "fc3": lin(nhidden, latent_dim)},
        "rec": {"i2h": lin(obs_dim + rnn_nhidden, rnn_nhidden),
                "h2o": lin(rnn_nhidden, latent_dim * 2)},
        "dec": {"fc1": lin(latent_dim, nhidden),
                "fc2": lin(nhidden, obs_dim)},
    }


def latent_field(func_params, t, z):
    """ELU MLP latent dynamics (latent_ode.py:108-125)."""
    h = F.elu(_linear(func_params["fc1"], z))
    h = F.elu(_linear(func_params["fc2"], h))
    return _linear(func_params["fc3"], h)


def encode(rec_params, samp_trajs, rnn_nhidden=25):
    """Reverse-time RNN encode of (B, T, obs_dim) to (qz0_mean,
    qz0_logvar) (latent_ode.py:127-144, 253-257)."""
    B = samp_trajs.shape[0]
    h = torch.zeros((B, rnn_nhidden), dtype=samp_trajs.dtype,
                    device=samp_trajs.device)
    for t in reversed(range(samp_trajs.shape[1])):
        combined = torch.cat([samp_trajs[:, t], h], dim=1)
        h = torch.tanh(_linear(rec_params["i2h"], combined))
    out = _linear(rec_params["h2o"], h)
    d = out.shape[-1] // 2
    return out[:, :d], out[:, d:]


def decode(dec_params, z):
    h = F.relu(_linear(dec_params["fc1"], z))
    return _linear(dec_params["fc2"], h)


def log_normal_pdf(x, mean, logvar):
    logvar = torch.as_tensor(logvar, dtype=x.dtype, device=x.device)
    return -0.5 * (math.log(2.0 * math.pi) + logvar
                   + (x - mean) ** 2 / torch.exp(logvar))


def normal_kl(mu1, lv1, mu2, lv2):
    v1, v2 = torch.exp(lv1), torch.exp(lv2)
    return lv2 / 2.0 - lv1 / 2.0 + (v1 + (mu1 - mu2) ** 2) / (2.0 * v2) - 0.5


def _elbo(odeint_fn: Callable, samp_trajs, samp_ts, noise_std: float,
          rnn_nhidden: int) -> Callable:
    """-ELBO(params, eps) on given reparameterization noise eps (B, L)."""
    noise_logvar = 2.0 * math.log(noise_std)

    def loss(params, eps):
        qz0_mean, qz0_logvar = encode(params["rec"], samp_trajs, rnn_nhidden)
        z0 = eps * torch.exp(0.5 * qz0_logvar) + qz0_mean
        pred_z = odeint_fn(lambda t, z: latent_field(params["func"], t, z),
                           z0, samp_ts)
        pred_z = pred_z.movedim(0, 1)                # (B, T, latent)
        pred_x = decode(params["dec"], pred_z)
        logpx = log_normal_pdf(samp_trajs, pred_x,
                               noise_logvar).sum(dim=(-2, -1))
        kl = normal_kl(qz0_mean, qz0_logvar, torch.zeros_like(qz0_mean),
                       torch.zeros_like(qz0_logvar)).sum(dim=-1)
        return (-logpx + kl).mean()

    return loss


def make_loss(odeint_fn: Callable, samp_trajs, samp_ts,
              noise_std: float = 0.3, rnn_nhidden: int = 25) -> Callable:
    """-ELBO(params, generator) (latent_ode.py:250-273): eps ~ N(0, I)
    (B, latent) from `generator`, on the trajectories' device and dtype."""
    body = _elbo(odeint_fn, samp_trajs, samp_ts, noise_std, rnn_nhidden)

    def loss(params, generator: torch.Generator):
        L = params["func"]["fc3"]["w"].shape[1]
        eps = torch.randn((samp_trajs.shape[0], L), generator=generator,
                          dtype=samp_trajs.dtype, device=samp_trajs.device)
        return body(params, eps)

    return loss


def generate_spiral2d(nspiral=1000, ntotal=500, nsample=100, start=0.0,
                      stop=6 * np.pi, noise_std=0.3, a=0.0, b=0.3, seed=0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """Archimedean-spiral dataset (latent_ode.py:39-105): clockwise and
    counter-clockwise spirals, random windows, additive noise (numpy, the
    JAX package's draws)."""
    rng = np.random.RandomState(seed)
    orig_ts = np.linspace(start, stop, num=ntotal)
    samp_ts = orig_ts[:nsample]

    zs_cw = stop + 1.0 - orig_ts
    rs_cw = a + b * 50.0 / zs_cw
    orig_cw = np.stack(
        [rs_cw * np.cos(zs_cw) - 5.0, rs_cw * np.sin(zs_cw)], axis=1
    )
    zs_cc = orig_ts
    rs_cc = a + b * zs_cc
    orig_cc = np.stack(
        [rs_cc * np.cos(zs_cc) + 5.0, rs_cc * np.sin(zs_cc)], axis=1
    )

    orig_trajs, samp_trajs = [], []
    for _ in range(nspiral):
        t0_idx = rng.randint(nsample, ntotal - nsample)
        orig = orig_cc if rng.rand() > 0.5 else orig_cw
        orig_trajs.append(orig)
        samp = orig[t0_idx : t0_idx + nsample].copy()
        samp += rng.randn(*samp.shape) * noise_std
        samp_trajs.append(samp)

    return (np.stack(orig_trajs), np.stack(samp_trajs), orig_ts, samp_ts)


def params_from_numpy(params, device="cpu", dtype=torch.float64):
    """The JAX package's parameter tree (nested dicts and lists of numpy
    arrays) as the port's."""
    return tree_map(lambda x: torch.as_tensor(np.array(x), dtype=dtype,
                                              device=device), params)
