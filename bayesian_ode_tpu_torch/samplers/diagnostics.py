"""Chain diagnostics: ESS (also per parameter), split R-hat, acceptance
rate and the kernel Stein discrepancy.

Counterpart of `bayesian_ode_tpu/samplers/diagnostics.py` (same
definitions: FFT autocovariance, Stan's multi-chain rho with Geyer's
initial monotone sequence truncation, the IMQ Stein kernel).
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


def acceptance_rate(infos) -> torch.Tensor:
    """Mean acceptance over the last axis of the stacked `accepted`
    flags of an info dict."""
    return infos["accepted"].to(torch.float32).mean(dim=-1)


def ess_per_param(positions: torch.Tensor) -> torch.Tensor:
    """ESS of each flattened parameter: positions (num_chains,
    num_samples, P) -> (P,)."""
    return torch.stack([ess(positions[:, :, i])
                        for i in range(positions.shape[2])])


def kernel_stein_discrepancy(samples: torch.Tensor, score_fn,
                             c: float = 1.0, beta: float = -0.5,
                             u_statistic: bool = False) -> torch.Tensor:
    """Kernel Stein discrepancy of (n, d) samples against a target given
    by its score `score_fn(x) -> grad log p(x)` for (n, d) x.

    The IMQ base kernel k(x, y) = (c^2 + |x - y|^2)^beta, beta in (-1, 0)
    (Gorham & Mackey 2017), whose Stein kernel is

      k_p(x, y) = k s(x)'s(y) + s(x)'grad_y k + s(y)'grad_x k
                  + tr(grad_x grad_y k),

    in closed form.  Returns the square root of the V-statistic mean
    (biased, non-negative), or with `u_statistic=True` the signed mean over
    the off-diagonal pairs (unbiased for KSD^2).  O(n^2 d) memory:
    subsample long chains first."""
    if not (-1.0 < beta < 0.0):
        raise ValueError("beta must lie in (-1, 0) for a detecting IMQ KSD")
    x = torch.atleast_2d(samples)
    n, d = x.shape
    s = score_fn(x)
    if s.shape != x.shape:
        raise ValueError("score_fn must map (n, d) -> (n, d)")
    r = x[:, None, :] - x[None, :, :]                   # (n, n, d)
    r2 = (r * r).sum(dim=-1)
    q = c * c + r2
    qb = q ** beta
    qb1 = q ** (beta - 1.0)
    ss = s @ s.T
    # s(x)'grad_y k + s(y)'grad_x k = 2 beta q^(beta-1) r'(s(y) - s(x))
    sx_r = torch.einsum("id,ijd->ij", s, r)
    sy_r = torch.einsum("jd,ijd->ij", s, r)
    cross = 2.0 * beta * qb1 * (sy_r - sx_r)
    trace = (-4.0 * beta * (beta - 1.0) * q ** (beta - 2.0) * r2
             - 2.0 * beta * d * qb1)
    kp = qb * ss + cross + trace
    if u_statistic:
        off = kp.sum() - torch.diagonal(kp).sum()
        return off / (n * (n - 1.0))
    return torch.sqrt(torch.clamp_min(kp.mean(), 0.0))
