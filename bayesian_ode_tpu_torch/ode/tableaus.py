"""Butcher tableau of the Dormand-Prince 5(4) pair.

Counterpart of `bayesian_ode_tpu/ode/tableaus.py` (only DOPRI5 so far; the
other pairs are ROADMAP queue 1 item 2).  Coefficients are plain Python
floats: multiplying a float32 tensor by one keeps float32, and float64 runs
read full-precision constants.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence


class ButcherTableau(NamedTuple):
    """Explicit RK tableau with embedded error estimate.

    alpha:   stage times c_2..c_s (the first stage is at t0).
    beta:    ragged lower-triangular stage weights, beta[i] has i+1 entries.
    c_sol:   solution weights over all s+1 stages (incl. the FSAL stage).
    c_error: b_i - b*_i, weights of the embedded error estimate.
    order:   order used by the step-size controller.
    c_mid:   midpoint weights for the 4th-order dense output.
    """

    alpha: Sequence[float]
    beta: Sequence[Sequence[float]]
    c_sol: Sequence[float]
    c_error: Sequence[float]
    order: int
    c_mid: Optional[Sequence[float]] = None


DOPRI5 = ButcherTableau(
    alpha=[1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0],
    beta=[
        [1 / 5],
        [3 / 40, 9 / 40],
        [44 / 45, -56 / 15, 32 / 9],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
        [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
    ],
    c_sol=[35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0],
    c_error=[
        35 / 384 - 1951 / 21600,
        0.0,
        500 / 1113 - 22642 / 50085,
        125 / 192 - 451 / 720,
        -2187 / 6784 - -12231 / 42400,
        11 / 84 - 649 / 6300,
        -1.0 / 60.0,
    ],
    c_mid=[
        6025192743 / 30085553152 / 2,
        0.0,
        51252292925 / 65400821598 / 2,
        -2691868925 / 45128329728 / 2,
        187940372067 / 1594534317056 / 2,
        -1776094331 / 19743644256 / 2,
        11237099 / 235043384 / 2,
    ],
    order=5,
)
