"""The arithmetic of kernel K8 (`csrc/svgd_phi.cu`), emulated in float32 on
the CPU, against float64, the plain version and the JAX Pallas kernel.

The kernel centres each 32-row tile on its first particle c (both the
distance d2 = |a_i|^2 + |b_j|^2 - 2 a_i . b_j and the gradient term
a_i sum_j K_ij - sum_j K_ij b_j are translation-invariant, a = x - c),
splits the 32-column tiles into S contiguous ranges whose partial sums a
second kernel adds in the order 0..S-1.  `centred_phi` repeats that
arithmetic with float32 tensor ops (its sums in another order than the
kernel's register loops: it checks the centring and the splits, not the
kernel's rounding, which the card tests hold).

Gates.  On the SVGD ensemble (the GP posterior's gradient-matched start
jittered by 0.005, as `chip_smoke.py` phase 13 builds it; |x|^2 about 120,
pairwise d2 about 4e-3) the uncentred float32 matmul form is percent-level
off float64 (the norm expansion cancels), the centred one within 1e-4.  On
N(0, 1) inputs, within the JAX kernel test's rtol 2e-5 / atol 2e-6 of the
plain version and of the JAX kernel in interpret mode.  S = 1 and S = 3
differ only in the order of the partial sums of 512 columns: within 2e-6
of max |phi|, about sixteen float32 roundings of its largest element
(4.5e-7 on the ensemble and 7.0e-7 on N(0, 1) inputs on a CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ops.pallas_rbf import svgd_phi_pallas
from bayesian_ode_tpu_torch.models import kernel_regression as kr
from bayesian_ode_tpu_torch.models import make_dataset
from bayesian_ode_tpu_torch.ops.gp_rk4 import make_fused_gp_potential
from bayesian_ode_tpu_torch.ops.svgd_phi import svgd_phi_reference
from bayesian_ode_tpu_torch.samplers import stein
from torch_parity import max_rel, one_torch_thread, to_np  # noqa: F401

ROWS, COLS = 32, 32          # csrc/svgd_phi.cu: kRows, kCols


def centred_phi(X, S, gamma, splits):
    """phi (n, d) as K8 computes it, in the dtype of X: each row tile
    centred on its first particle, the column tiles in `splits` contiguous
    ranges, the ranges' partial sums added in order."""
    n, d = X.shape
    tiles = -(-n // COLS)
    per = -(-tiles // splits)
    out = torch.empty_like(X)
    for row0 in range(0, n, ROWS):
        c = X[row0]
        A = X[row0:row0 + ROWS] - c
        aa = (A * A).sum(dim=1)
        ks = kx = ksum = 0.0
        for s in range(splits):
            cols = slice(s * per * COLS, min(n, (s + 1) * per * COLS))
            B = X[cols] - c
            d2 = torch.clamp_min(
                aa[:, None] + (B * B).sum(dim=1)[None] - 2.0 * A @ B.T, 0.0)
            K = torch.exp(-gamma * d2)
            ks = ks + K @ S[cols]
            kx = kx + K @ B
            ksum = ksum + K.sum(dim=1)
        out[row0:row0 + ROWS] = (ks + 2.0 * gamma * (A * ksum[:, None] - kx)
                                 ) / n
    return out


@pytest.fixture(scope="module")
def ensemble():
    """512 particles of the GP posterior (74 parameters: U then logsn)
    jittered by 0.005 around the gradient-matched start, with the scores
    of the fused rk4 potential (its plain version on the CPU), in
    float32."""
    n = 512
    data = make_dataset(seed=2, ode="vdp", N=5, T=60, t_max=6.0, noise=0.05,
                        x0_scale=1.5)
    static = kr.make_static(kr.make_inducing_grid(data["Y"], M=6), sf=1.0,
                            ell=0.75)
    p0 = kr.init_params(data["Y"], data["t"], static, noise=0.05)
    rng = np.random.RandomState(12)
    f32 = torch.float32
    U = p0["U"].to(f32)[None] + 0.005 * torch.tensor(
        rng.randn(n, 36, 2), dtype=f32)
    logsn = p0["logsn"].to(f32)[None] + 0.005 * torch.tensor(
        rng.randn(n, 2), dtype=f32)
    s32 = kr.GPVectorFieldStatic(
        Z=static.Z.to(f32), KzzinvL=static.KzzinvL.to(f32),
        Kzzinv=static.Kzzinv.to(f32), sf=static.sf, ell=static.ell)
    pot = make_fused_gp_potential(s32, data["x0"].to(f32),
                                  data["t"].to(f32), data["Y"].to(f32))
    u = U.requires_grad_(True)
    g = logsn.requires_grad_(True)
    gu, gl = torch.autograd.grad(pot({"U": u, "logsn": g}).sum(), [u, g])
    X = torch.cat([U.detach().reshape(n, -1), logsn.detach()], dim=1)
    S = -torch.cat([gu.reshape(n, -1), gl], dim=1)
    gamma = float(stein.rbf_bandwidth(X, None, 256))
    truth = svgd_phi_reference(X.double(), S.double(), gamma)
    return X, S, gamma, truth


def test_centring_removes_the_cancellation_on_the_ensemble(ensemble):
    X, S, gamma, truth = ensemble
    assert X.shape == (512, 74)
    assert float((X * X).sum(dim=1).mean()) > 50.0
    plain = max_rel(svgd_phi_reference(X, S, gamma).double(), truth)
    centred = max_rel(centred_phi(X, S, gamma, 4).double(), truth)
    assert plain > 1e-3, plain
    assert centred <= 1e-4, centred


def _normal(n, d, seed):
    rng = np.random.RandomState(seed)
    return (torch.tensor(rng.randn(n, d), dtype=torch.float32),
            torch.tensor(rng.randn(n, d), dtype=torch.float32))


@pytest.mark.parametrize("n,d,splits", [(300, 74, 3), (130, 5, 2),
                                        (64, 200, 1)])
def test_centred_matches_plain_and_jax_on_normal_inputs(n, d, splits):
    """Ragged row and column tiles, a width past one 96-feature chunk; the
    JAX kernel as its own tests run it on the CPU (interpret mode)."""
    X, S = _normal(n, d, seed=n + d)
    gamma = float(stein.rbf_bandwidth(X, None, 256))
    got = centred_phi(X, S, gamma, splits)
    want = svgd_phi_reference(X, S, gamma)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    pallas = svgd_phi_pallas(jnp.asarray(to_np(X)), jnp.asarray(to_np(S)),
                             gamma, tile_rows=128, interpret=True)
    np.testing.assert_allclose(to_np(got), np.asarray(pallas), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("inputs", ["ensemble", "normal"])
def test_column_splits_change_only_the_order_of_the_sums(ensemble, inputs):
    if inputs == "ensemble":
        X, S, gamma, _ = ensemble
    else:
        X, S = _normal(512, 74, seed=3)
        gamma = float(stein.rbf_bandwidth(X, None, 256))
    one = centred_phi(X, S, gamma, 1)
    three = centred_phi(X, S, gamma, 3)
    assert max_rel(three, one) <= 2e-6
