"""Chain diagnostics: ESS and split R-hat.

Counterpart of `bayesian_ode_tpu/samplers/diagnostics.py` (same
definitions: FFT autocovariance, Stan's multi-chain rho with Geyer's
initial monotone sequence truncation).
"""
from __future__ import annotations

import math

import torch


def autocovariance(x: torch.Tensor) -> torch.Tensor:
    """Biased autocovariance along the last axis via FFT, normalized by n."""
    n = x.shape[-1]
    xc = x - x.mean(dim=-1, keepdim=True)
    m = int(2 ** math.ceil(math.log2(2 * n)))     # linear, not circular
    f = torch.fft.rfft(xc, n=m)
    return torch.fft.irfft(f * torch.conj(f), n=m)[..., :n] / n


def ess(chains: torch.Tensor) -> torch.Tensor:
    """Effective sample size of (num_chains, num_samples) scalar draws."""
    chains = torch.atleast_2d(chains)
    m, n = chains.shape
    acovs = autocovariance(chains)                  # (m, n)
    mean_acov = acovs.mean(dim=0)
    w = mean_acov[0] * n / (n - 1.0)                # within-chain variance
    var_plus = w * (n - 1.0) / n
    if m > 1:
        var_plus = var_plus + torch.var(chains.mean(dim=1), correction=1)
    rho = 1.0 - (w - mean_acov) / var_plus          # (n,)
    pair_len = (n - 1) // 2
    pairs = rho[1:1 + 2 * pair_len].reshape(pair_len, 2).sum(dim=1)
    good = torch.cumprod((pairs > 0.0).to(rho.dtype), dim=0).bool()
    capped = torch.where(good, pairs, torch.full_like(pairs, math.inf))
    pairs = torch.minimum(pairs, torch.cummin(capped, dim=0).values)
    tau = 1.0 + 2.0 * torch.where(good, pairs, torch.zeros_like(pairs)).sum()
    return m * n / torch.clamp_min(tau, 1e-12)


def split_rhat(chains: torch.Tensor) -> torch.Tensor:
    """Split-R-hat of (num_chains, num_samples) scalar draws."""
    chains = torch.atleast_2d(chains)
    half = chains.shape[1] // 2
    split = torch.cat([chains[:, :half], chains[:, half:2 * half]], dim=0)
    sn = split.shape[1]
    chain_means = split.mean(dim=1)
    chain_vars = torch.var(split, dim=1, correction=1)
    B = sn * torch.var(chain_means, correction=1)
    W = chain_vars.mean()
    var_plus = (sn - 1.0) / sn * W + B / sn
    return torch.sqrt(var_plus / W)
