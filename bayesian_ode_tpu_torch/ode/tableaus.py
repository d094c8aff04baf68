"""Butcher tableaus of the Dormand-Prince and Tsitouras 5(4) pairs.

Counterpart of `bayesian_ode_tpu/ode/tableaus.py` (DOPRI5 and TSIT5, the
two pairs of the fused adaptive engine and of the generic `odeint`; the
other pairs are ROADMAP queue 1 item 16), and the Tsitouras dense-output
weights `tsit5_interp_coeffs`.  Coefficients are plain Python floats, copied as the JAX package
states them: multiplying a float32 tensor by one keeps float32, and
float64 runs read full-precision constants.  `csrc/dopri5_common.cuh`
holds the same two tableaus for the kernels.
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

# Tsitouras 5(4).  The c_error row is the JAX package's corrected one
# (b_i - bhat_i of the embedded 4th-order pair, summing to 0; the reference
# implementation subtracts the difference coefficients as if they were
# bhat_i), and c_mid its derived midpoint weights for the 4th-order quartic
# dense output of the fused engine.
TSIT5 = ButcherTableau(
    alpha=[0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0],
    beta=[
        [0.161],
        [-0.008480655492357, 0.3354806554923570],
        [2.897153057105494, -6.359448489975075, 4.362295432869581],
        [5.32586482843925895, -11.74888356406283, 7.495539342889836,
         -0.09249506636175525],
        [
            5.86145544294642038,
            -12.92096931784711,
            8.159367898576159,
            -0.071584973281401006,
            -0.02826905039406838,
        ],
        [
            0.09646076681806523,
            0.01,
            0.4798896504144996,
            1.379008574103742,
            -3.290069515436081,
            2.324710524099774,
        ],
    ],
    c_sol=[
        0.09646076681806523,
        0.01,
        0.4798896504144996,
        1.379008574103742,
        -3.290069515436081,
        2.324710524099774,
        0.0,
    ],
    c_error=[
        0.00178001105222577714,
        0.0008164344596567469,
        -0.007880878010261995,
        0.1447110071732629,
        -0.5823571654525552,
        0.4580821059291869,
        -1 / 66,
    ],
    c_mid=[
        0.11142574892073395,
        0.013197067390738587,
        0.37783998967297555,
        -0.018471772229541692,
        0.0031427990704557002,
        0.01577833690800391,
        -0.0029121697333658932,
    ],
    order=5,
)


def tsit5_interp_coeffs(theta):
    """Dense-output weights b_i(theta) of the Tsitouras interpolant at
    theta = (t - t0) / dt in [0, 1], combined as y0 + dt * sum_i b_i k_i
    with the interval's true start y0 (the JAX package's correction of the
    reference, which substitutes k[0] = f0 for y0)."""
    t = theta
    b1 = (-1.0530884977290216 * t * (t - 1.3299890189751412)
          * (t * t - 1.4364028541716351 * t + 0.7139816917074209))
    b2 = 0.1017 * t * t * (t * t - 2.1966568338249754 * t
                           + 1.2949852507374631)
    b3 = 2.490627285651252793 * t * t * (t * t - 2.38535645472061657 * t
                                         + 1.57803468208092486)
    b4 = (-16.54810288924490272 * (t - 1.21712927295533244)
          * (t - 0.61620406037800089) * t * t)
    b5 = (47.37952196281928122 * (t - 1.203071208372362603)
          * (t - 0.658047292653547382) * t * t)
    b6 = -34.87065786149660974 * (t - 1.2) * (t - 0.666666666666666667) * t * t
    b7 = 2.5 * (t - 1.0) * (t - 0.6) * t * t
    return [b1, b2, b3, b4, b5, b6, b7]
