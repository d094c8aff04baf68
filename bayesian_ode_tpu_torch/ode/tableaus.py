"""Butcher tableaus of the explicit adaptive pairs.

Counterpart of `bayesian_ode_tpu/ode/tableaus.py`: DOPRI5 and TSIT5 (the
two pairs of the fused adaptive engine and of the generic `odeint`),
BOSH3, FEHLBERG2, ADAPTIVE_HEUN and DOPRI8 (Hairer's DOP853, with its
composite-error row and the 7th-order dense output `DOPRI8_DENSE`), and
the Tsitouras dense-output weights `tsit5_interp_coeffs`.  Coefficients are plain Python floats, copied as the JAX package
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
    c_error_alt: the second embedded error row of a composite estimate
             (DOP853's 8(5,3): the ratio is r5^2 / (r5 + 0.01 r3)).
    """

    alpha: Sequence[float]
    beta: Sequence[Sequence[float]]
    c_sol: Sequence[float]
    c_error: Sequence[float]
    order: int
    c_mid: Optional[Sequence[float]] = None
    c_error_alt: Optional[Sequence[float]] = None

    @property
    def is_fsal(self) -> bool:
        """The last stage is f(t1, y1): y1 is the last stage point and f1
        comes free.  Non-FSAL pairs (FEHLBERG2, ADAPTIVE_HEUN) pay one
        more RHS evaluation a step for f(t1, y1)."""
        return (self.c_sol[-1] == 0.0
                and list(self.c_sol[:-1]) == list(self.beta[-1]))

    @property
    def nfe_per_step(self) -> int:
        """RHS evaluations an attempted step takes beyond the carried
        f0."""
        return len(self.alpha) + (0 if self.is_fsal else 1)


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


# Bogacki-Shampine 3(2), upstream torchdiffeq's "bosh3": FSAL, 3 stages.
BOSH3 = ButcherTableau(
    alpha=[1 / 2, 3 / 4, 1.0],
    beta=[
        [1 / 2],
        [0.0, 3 / 4],
        [2 / 9, 1 / 3, 4 / 9],
    ],
    c_sol=[2 / 9, 1 / 3, 4 / 9, 0.0],
    # b - bhat with the embedded 2nd-order bhat = [7/24, 1/4, 1/3, 1/8].
    c_error=[2 / 9 - 7 / 24, 1 / 3 - 1 / 4, 4 / 9 - 1 / 3, -1 / 8],
    order=3,
)

# Fehlberg RK1(2).  Upstream-torchdiffeq name; non-FSAL.
FEHLBERG2 = ButcherTableau(
    alpha=[1 / 2, 1.0],
    beta=[
        [1 / 2],
        [1 / 256, 255 / 256],
    ],
    c_sol=[1 / 512, 255 / 256, 1 / 512],
    # b - bhat with the 1st-order bhat = [1/256, 255/256, 0].
    c_error=[1 / 512 - 1 / 256, 0.0, 1 / 512],
    order=2,
)

# Heun-Euler 2(1): trapezoidal corrector with embedded Euler error
# estimate.  Upstream-torchdiffeq name 'adaptive_heun'; non-FSAL.
ADAPTIVE_HEUN = ButcherTableau(
    alpha=[1.0],
    beta=[[1.0]],
    c_sol=[1 / 2, 1 / 2],
    # b - bhat with the embedded Euler bhat = [1, 0].
    c_error=[-1 / 2, 1 / 2],
    order=2,
)


# Dormand-Prince 8(5,3), Hairer's DOP853 (the published dop853.f
# coefficients), upstream torchdiffeq's "dopri8": 12 stages and the FSAL
# 13th; c_error_alt is the 3rd-order row of the composite error, and c_mid
# the JAX package's least-norm midpoint weights for the quartic fallback
# (options={"interp": "quartic"}).
DOPRI8 = ButcherTableau(
    alpha=[
        0.05260015195876773,
        0.0789002279381516,
        0.1183503419072274,
        0.2816496580927726,
        0.3333333333333333,
        0.25,
        0.3076923076923077,
        0.6512820512820513,
        0.6,
        0.8571428571428571,
        1.0,
        1.0,
    ],
    beta=[
        [0.05260015195876773],
        [0.0197250569845379, 0.0591751709536137],
        [0.02958758547680685, 0.0, 0.08876275643042054],
        [0.2413651341592667, 0.0, -0.8845494793282861, 0.924834003261792],
        [0.037037037037037035, 0.0, 0.0, 0.17082860872947386,
         0.12546768756682242],
        [0.037109375, 0.0, 0.0, 0.17025221101954405, 0.06021653898045596,
         -0.017578125],
        [0.03709200011850479, 0.0, 0.0, 0.17038392571223998,
         0.10726203044637328, -0.015319437748624402, 0.008273789163814023],
        [0.6241109587160757, 0.0, 0.0, -3.3608926294469414,
         -0.868219346841726, 27.59209969944671, 20.154067550477894,
         -43.48988418106996],
        [0.47766253643826434, 0.0, 0.0, -2.4881146199716677,
         -0.590290826836843, 21.230051448181193, 15.279233632882423,
         -33.28821096898486, -0.020331201708508627],
        [-0.9371424300859873, 0.0, 0.0, 5.186372428844064,
         1.0914373489967295, -8.149787010746927, -18.52006565999696,
         22.739487099350505, 2.4936055526796523, -3.0467644718982196],
        [2.273310147516538, 0.0, 0.0, -10.53449546673725,
         -2.0008720582248625, -17.9589318631188, 27.94888452941996,
         -2.8589982771350235, -8.87285693353063, 12.360567175794303,
         0.6433927460157636],
        [0.054293734116568765, 0.0, 0.0, 0.0, 0.0, 4.450312892752409,
         1.8915178993145003, -5.801203960010585, 0.3111643669578199,
         -0.1521609496625161, 0.20136540080403034, 0.04471061572777259],
    ],
    c_sol=[0.054293734116568765, 0.0, 0.0, 0.0, 0.0, 4.450312892752409,
           1.8915178993145003, -5.801203960010585, 0.3111643669578199,
           -0.1521609496625161, 0.20136540080403034, 0.04471061572777259,
           0.0],
    c_error=[0.01312004499419488, 0.0, 0.0, 0.0, 0.0, -1.2251564463762044,
             -0.4957589496572502, 1.6643771824549864, -0.35032884874997366,
             0.3341791187130175, 0.08192320648511571, -0.022355307863886294,
             0.0],
    c_error_alt=[-0.18980075407240762, 0.0, 0.0, 0.0, 0.0, 4.450312892752409,
                 1.8915178993145003, -5.801203960010585, -0.4226823213237919,
                 -0.1521609496625161, 0.20136540080403034,
                 0.02265179219836082, 0.0],
    c_mid=[0.06299848107574937, 0.0, 0.0, 0.08234922769198014,
           0.08022273109017813, 0.07449347942940907, 0.0827098104060126,
           0.07757459011747807, 0.018029032661530157, 0.02736281846549874,
           -0.006034093698243677, 0.00014696138085495102,
           0.0001469613793815324],
    order=8,
)


# DOP853 7th-order dense output (Hairer's dop853.f CONTD8):
# three extra stages evaluated per accepted step plus four
# D-matrix contractions over all 16 stages.  Constants are the
# published dop853 dense-output set (same data scipy ships).
DOPRI8_DENSE = {
    "c_extra": [0.1, 0.2, 0.7777777777777778],
    "a_extra": [
        [0.056167502283047954, 0.0, 0.0, 0.0, 0.0, 0.0, 0.25350021021662483, -0.2462390374708025, -0.12419142326381637, 0.15329179827876568, 0.00820105229563469, 0.007567897660545699, -0.008298],
        [0.03183464816350214, 0.0, 0.0, 0.0, 0.0, 0.028300909672366776, 0.053541988307438566, -0.05492374857139099, 0.0, 0.0, -0.00010834732869724932, 0.0003825710908356584, -0.00034046500868740456, 0.1413124436746325],
        [-0.42889630158379194, 0.0, 0.0, 0.0, 0.0, -4.697621415361164, 7.683421196062599, 4.06898981839711, 0.3567271874552811, 0.0, 0.0, 0.0, -0.0013990241651590145, 2.9475147891527724, -9.15095847217987],
    ],
    "d": [
        [-8.428938276109013, 0.0, 0.0, 0.0, 0.0, 0.5667149535193777, -3.0689499459498917, 2.38466765651207, 2.117034582445028, -0.871391583777973, 2.2404374302607883, 0.6315787787694688, -0.08899033645133331, 18.148505520854727, -9.194632392478356, -4.436036387594894],
        [10.427508642579134, 0.0, 0.0, 0.0, 0.0, 242.28349177525817, 165.20045171727028, -374.5467547226902, -22.113666853125306, 7.733432668472264, -30.674084731089398, -9.332130526430229, 15.697238121770845, -31.139403219565178, -9.35292435884448, 35.81684148639408],
        [19.985053242002433, 0.0, 0.0, 0.0, 0.0, -387.0373087493518, -189.17813819516758, 527.8081592054236, -11.57390253995963, 6.8812326946963, -1.0006050966910838, 0.7777137798053443, -2.778205752353508, -60.19669523126412, 84.32040550667716, 11.99229113618279],
        [-25.69393346270375, 0.0, 0.0, 0.0, 0.0, -154.18974869023643, -231.5293791760455, 357.6391179106141, 93.40532418362432, -37.45832313645163, 104.0996495089623, 29.8402934266605, -43.53345659001114, 96.32455395918828, -39.17726167561544, -149.72683625798564],
    ],
}


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
