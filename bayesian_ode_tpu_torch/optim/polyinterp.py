"""minFunc-style polynomial interpolation for the L-BFGS line searches.

Counterpart of `bayesian_ode_tpu/optim/polyinterp.py` (a port of Mark
Schmidt's minFunc polyinterp.m): the three live cases of the reference's
dispatch as separate functions of 0-d tensors,

  - two points, gradient at one  -> the quadratic's minimizer (`quad_min`),
  - two points, gradients at both -> the cubic's minimizer, bisection when
    the discriminant is negative (`cubic_min`),
  - three values and one gradient -> the interpolating cubic by a linear
    solve, its critical points and the bounds tested (`cubic_min_3pt`).

Each clamps into [lo, hi] and falls back to bisection (lo+hi)/2 on
degenerate or non-finite input.  Everything is `torch.where`-based, so the
functions make no host read.
"""
from __future__ import annotations

import math

import torch


def _safeguard(x_sol, lo, hi):
    """Clamp into [lo, hi]; bisection on non-finite (the reference's
    clamps propagate NaN, which its own safeguards then miss)."""
    mid = 0.5 * (lo + hi)
    x_sol = torch.where(torch.isfinite(x_sol), x_sol, mid)
    return torch.minimum(torch.maximum(x_sol, lo), hi)


def quad_min(x1, f1, g1, x2, f2, lo, hi):
    """Minimizer of the quadratic through (x1, f1) with slope g1 at x1 and
    (x2, f2); a concave model's stationary point is clamped into [lo, hi],
    as in the reference."""
    dx = x1 - x2
    dxs = torch.where(dx == 0, 1.0, dx)
    a = -(f1 - f2 - g1 * dxs) / (dxs * dxs)
    x_sol = x1 - g1 / torch.where(a == 0, math.inf, 2.0 * a)
    x_sol = torch.where(dx == 0, math.nan, x_sol)
    return _safeguard(x_sol, lo, hi)


def cubic_min(x1, f1, g1, x2, f2, g2, lo, hi):
    """Minimizer of the cubic matching (f, g) at both points; bisection
    when the discriminant goes negative."""
    dx = x1 - x2
    dxs = torch.where(dx == 0, 1.0, dx)
    d1 = g1 + g2 - 3.0 * (f1 - f2) / dxs
    disc = d1 * d1 - g1 * g2
    d2 = torch.sqrt(torch.clamp(disc, min=0.0))
    denom = g2 - g1 + 2.0 * d2
    x_sol = x2 - (x2 - x1) * (g2 + d2 - d1) / torch.where(
        denom == 0, math.inf, denom)
    x_sol = torch.where((disc >= 0) & (dx != 0), x_sol, math.nan)
    return _safeguard(x_sol, lo, hi)


def cubic_min_3pt(x1, f1, g1, x2, f2, x3, f3, lo, hi):
    """Minimizer of the cubic through three function values and the
    gradient at x1: fit c0 x^3 + c1 x^2 + c2 x + c3, evaluate it at its two
    critical points, lo, hi, x1, x2 and x3 (those in bounds) and return the
    argmin, bisection when nothing qualifies (a singular system gives NaN
    coefficients, as the reference's rank check rejects it)."""
    one, zero = torch.ones_like(x1), torch.zeros_like(x1)
    A = torch.stack([
        torch.stack([x1 ** 3, x1 ** 2, x1, one]),
        torch.stack([x2 ** 3, x2 ** 2, x2, one]),
        torch.stack([x3 ** 3, x3 ** 2, x3, one]),
        torch.stack([3.0 * x1 ** 2, 2.0 * x1, one, zero]),
    ])
    b = torch.stack([f1, f2, f3, g1])
    c, info = torch.linalg.solve_ex(A, b)
    c = torch.where(info == 0, c, math.nan)

    # critical points: roots of 3 c0 x^2 + 2 c1 x + c2
    qa, qb, qc = 3.0 * c[0], 2.0 * c[1], c[2]
    disc = qb * qb - 4.0 * qa * qc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    qa_s = torch.where(qa == 0, math.inf, 2.0 * qa)
    r1 = (-qb + sq) / qa_s
    r2 = (-qb - sq) / qa_s
    # the quadratic's root when the cubic coefficient vanishes
    r_quad = -qc / torch.where(qb == 0, math.inf, qb)
    r1 = torch.where(qa == 0, r_quad, torch.where(disc >= 0, r1, math.nan))
    r2 = torch.where((qa != 0) & (disc >= 0), r2, math.nan)

    cand = torch.stack([lo, hi, x1, x2, x3, r1, r2])
    fval = ((c[0] * cand + c[1]) * cand + c[2]) * cand + c[3]
    ok = (torch.isfinite(cand) & torch.isfinite(fval) & (cand >= lo)
          & (cand <= hi))
    fval = torch.where(ok, fval, math.inf)
    best = torch.argmin(fval)
    return torch.where(torch.isfinite(fval[best]), cand[best],
                       0.5 * (lo + hi))
