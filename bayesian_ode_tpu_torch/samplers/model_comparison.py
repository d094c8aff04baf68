"""Predictive model comparison: WAIC and PSIS-LOO from posterior draws.

Counterpart of `bayesian_ode_tpu/samplers/model_comparison.py`: pure
tensor math on an (S, N) matrix of pointwise log-likelihoods (draws x
data points), on whatever device and dtype it lies.

  - `waic` (Watanabe 2010): elpd ~= lppd - p_waic with
    p_waic = sum_n Var_s[log p(y_n | theta_s)].
  - `psis_loo` (Vehtari, Gelman & Gabry 2017): leave-one-out elpd by
    importance sampling with Pareto-smoothed weights; the largest
    M = min(0.2 S, 3 sqrt(S)) raw weights of each point are replaced by
    the expected order statistics of a generalized Pareto fit (Zhang &
    Stephens 2009, `gpd_fit`), all points at once.  pareto_k > 0.7 flags
    a point whose LOO estimate is unreliable.
  - `compare`: paired elpd difference with its standard error.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["ElpdResult", "CompareResult", "waic", "psis_loo", "compare",
           "gpd_fit"]


class ElpdResult(NamedTuple):
    elpd: torch.Tensor       # expected log pointwise predictive density
    se: torch.Tensor         # standard error of elpd (sqrt(N * var_n))
    p_eff: torch.Tensor      # effective number of parameters
    pointwise: torch.Tensor  # (N,) per-point elpd contributions
    pareto_k: torch.Tensor   # (N,) PSIS khat (NaN for waic)


class CompareResult(NamedTuple):
    elpd_diff: torch.Tensor  # elpd_a - elpd_b
    se_diff: torch.Tensor    # paired SE of the difference
    better: torch.Tensor     # elpd_diff > 0


def _canon(log_lik) -> torch.Tensor:
    ll = torch.as_tensor(log_lik)
    if ll.dim() == 3:         # (S, C, N) chains folded into draws
        ll = ll.reshape(-1, ll.shape[-1])
    if ll.dim() != 2:
        raise ValueError("log_lik must be (S, N) or (S, C, N)")
    return ll


def _se(pointwise: torch.Tensor) -> torch.Tensor:
    n = pointwise.shape[0]
    return torch.sqrt(n * pointwise.var(correction=0))


def waic(log_lik) -> ElpdResult:
    """WAIC from an (S, N) [or (S, C, N)] pointwise log-likelihood matrix."""
    ll = _canon(log_lik)
    s = ll.shape[0]
    lppd = torch.logsumexp(ll, dim=0) - math.log(s)
    p = ll.var(dim=0, correction=1)
    pointwise = lppd - p
    return ElpdResult(pointwise.sum(), _se(pointwise), p.sum(), pointwise,
                      torch.full((ll.shape[1],), float("nan"),
                                 dtype=ll.dtype, device=ll.device))


def gpd_fit(x: torch.Tensor):
    """Generalized-Pareto (k, sigma) for exceedances `x` (sorted ascending
    along dim 0, all > 0; trailing dims are independent fits) by the
    Zhang & Stephens (2009) quadrature posterior mean on a fixed grid.
    Heavy tails have k > 0 (Vehtari et al. 2017 eq. 12)."""
    n = x.shape[0]
    m = 30 + int(math.sqrt(n))
    tail = (1,) * (x.dim() - 1)
    j = torch.arange(1, m + 1, dtype=x.dtype, device=x.device)
    quart = x[int(n / 4 + 0.5) - 1]
    b = 1.0 / x[-1] + ((1.0 - torch.sqrt(m / (j - 0.5))).reshape((m,) + tail)
                       / (3.0 * quart))                        # (m, ...)
    k_b = torch.log1p(-b[:, None] * x[None]).mean(dim=1)       # (m, ...)
    prof = n * (torch.log(-b / k_b) - k_b - 1.0)
    w = torch.softmax(prof, dim=0)
    b_post = (b * w).sum(dim=0)
    # with theta = b: k = mean log1p(-b x), heavy tail <=> b < 0 <=> k > 0
    k_post = torch.log1p(-b_post * x).mean(dim=0)
    sigma = -k_post / b_post
    # the weakly informative pull toward k = 0.5 (as arviz and loo)
    k_post = (n * k_post + 5.0) / (n + 10.0)
    return k_post, sigma


def _psis(ll: torch.Tensor, tail: int):
    """Pareto-smoothed, normalized LOO log-weights of every point (columns
    of ll (S, N)): the raw log-weights -ll, whose top `tail` order
    statistics are replaced by GPD quantiles fitted to the exceedances
    over the (S - tail)-th weight and capped at the raw maximum
    (Vehtari et al. 2017 section 3.2).  Returns ((S, N) log-weights,
    (N,) khat)."""
    s = ll.shape[0]
    lw = -ll
    lw = lw - lw.max(dim=0).values                 # overflow guard
    order = torch.argsort(lw, dim=0, stable=True)
    lw_sorted = torch.gather(lw, 0, order)
    cut = lw_sorted[s - tail - 1]                  # tail threshold (log)
    exceed = torch.exp(lw_sorted[s - tail:]) - torch.exp(cut)
    k, sigma = gpd_fit(exceed)
    # expected order statistics: the inverse GPD cdf at (i - 1/2) / tail
    p = ((torch.arange(1, tail + 1, dtype=lw.dtype, device=lw.device) - 0.5)
         / tail)[:, None]
    tiny = k.abs() < 1e-6
    safe_k = torch.where(tiny, torch.ones_like(k), k)
    q = torch.where(tiny, -torch.log1p(-p) * sigma,
                    sigma / safe_k * (torch.pow(1.0 - p, -k) - 1.0))
    smoothed = torch.log(torch.exp(cut) + q)
    smoothed = torch.minimum(smoothed, lw_sorted[-1])   # cap at raw max
    lw_new = torch.cat([lw_sorted[:s - tail], smoothed])
    lw_out = torch.empty_like(lw_new).scatter_(0, order, lw_new)
    return lw_out - torch.logsumexp(lw_out, dim=0), k


def psis_loo(log_lik) -> ElpdResult:
    """PSIS-LOO elpd from an (S, N) [or (S, C, N)] pointwise
    log-likelihood matrix.  `pareto_k[n] > 0.7` means point n's LOO
    estimate is unreliable."""
    ll = _canon(log_lik)
    s = ll.shape[0]
    tail = int(min(0.2 * s, 3.0 * math.sqrt(s)))
    if tail < 5:
        raise ValueError(f"need >= 25 draws for PSIS (tail={tail} < 5)")
    lw, k = _psis(ll, tail)
    pointwise = torch.logsumexp(lw + ll, dim=0)                   # (N,)
    lppd = torch.logsumexp(ll, dim=0) - math.log(s)
    p_eff = (lppd - pointwise).sum()
    return ElpdResult(pointwise.sum(), _se(pointwise), p_eff, pointwise, k)


def compare(a: ElpdResult, b: ElpdResult) -> CompareResult:
    """Paired comparison: elpd_a - elpd_b with the SE of the pointwise
    differences (Vehtari et al. 2017 eq. 24)."""
    if a.pointwise.shape != b.pointwise.shape:
        raise ValueError("models must score the same data points")
    d = a.pointwise - b.pointwise
    return CompareResult(d.sum(), _se(d), d.sum() > 0)
