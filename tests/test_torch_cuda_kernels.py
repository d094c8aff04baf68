"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: every test skips where torch sees no CUDA device.  On a
machine with an H100 and nvcc they run with

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda_kernels.py

(`--noconftest` because the suite's conftest imports JAX, which that
machine need not have; this file imports torch and the port only).

Small shapes and the cases `chip_smoke.py` does not reach at full size:
a chain count that is not a multiple of the 64-thread block (or of the
warps of a warp-per-chain field's block, or of the 6 chains a warp and 24
a block of the GP field's per-point kernels, K1, K2, K3 GP, K4 and K5,
also built at N=3; or of the spiral's 4 warps a block), the MLP field at
H=20 (lanes past H hold zeros) and at the driver's H=32 (K7, K2 at 257
chains and K3 under both tableaus against the plain replay of its
records), the PI controller, budget exhaustion, record overflow, a spiral
of 50 hidden units (two per lane) and one of 20 under both tableaus, the
SVGD direction (K8) at particle counts and widths that are not multiples
of its tiles, on the clustered SVGD ensemble against float64 and bit for
bit from call to call, and the per-step solver (K9) against the whole solve
and, with a budget that binds, against the JAX package's loop.  The
wide shapes the JAX package takes: the GP kernels (K1-K5, K9) at 7x7 and
8x8 inducing grids (their blocks' buffers in dynamic shared memory), the
MLP kernels (K6, K7, MLP K2/K3) at N=9 and 16 trajectory points and,
past one warp (csrc/mlp_wide_field.cuh), at (N, H) = (5, 66), (5, 128),
(32, 64) and (17, 4), and the spiral's K2/K3 at N=9, H=6; the GP kernels
past one warp or a block's shared memory (csrc/gp_wide_field.cuh: K1-K5
and K9 at N = 40 and 100 on a 6x6 and a 4x4 grid, at N = 5 on a 15x15
grid, K3 and K5 wide there, and at N = 2 on a 32x32 grid, every kernel
wide there) and the spiral's K2/K3 past one warp's lanes or 48 KB
(csrc/spiral_wide_field.cuh: (N, H) = (20, 40), (16, 128), (32, 50));
the spread forwards (spiral K2 one state component a lane at N=5, 9 and 16, FHN K2
and K3 one trajectory point a thread at N=5 and 32 and one chain a thread
at N=40) under both tableaus, with and without records, and the same
bits from call to call; and each library's shared memory as built
against the shape check's arithmetic.  All
libraries are built at once, one nvcc per source, by the first fixture.
Gates as the smoke's: dopri5 trajectories within 1e-4 * max|y| of the
plain version (two float32 solves whose step meshes differ by rounding in
the floor-bound regime),
mean NFE within 1%, gradients within 1e-3 max-rel (the JAX package's
float32 gate).  The fixed-grid rk4 kernels (K4-K7) take the same steps as
their plain versions, so they are held closer: trajectories within
1e-5 * max|y| and cotangents within 1e-5 max-rel.  K8 on N(0, 1) inputs
within the JAX kernel test's rtol 2e-5 / atol 2e-6 of its plain version;
K9 with K1's per-chain step counts and within 5e-6 of its trajectories
(the JAX package's gate between its two kernels).
"""
import sys
from pathlib import Path

import pytest
import torch

from bayesian_ode_tpu_torch.models import kernel_regression as kr
from bayesian_ode_tpu_torch.models import make_dataset
from bayesian_ode_tpu_torch.models.mlp import init_mlp
from bayesian_ode_tpu_torch.ops import _build
from bayesian_ode_tpu_torch.ops import fused_adaptive as fa
from bayesian_ode_tpu_torch.ops import fused_field as ff
from bayesian_ode_tpu_torch.ops import gp_rk4, mlp_rk4
from bayesian_ode_tpu_torch.ops.fhn_dopri5 import fhn_field
from bayesian_ode_tpu_torch.ops.gp_dopri5 import (
    _pack_initial,
    gp_dopri5_solve,
    gp_dopri5_solve_plain,
    gp_dopri5_solve_whole,
    gp_dopri5_solve_whole_plain,
)
from bayesian_ode_tpu_torch.ops.gp_dopri5_grad import (
    gp_dopri5_trajectory,
    gp_dopri5_trajectory_plain,
    make_fused_gp_potential_dopri5,
)
from bayesian_ode_tpu_torch.ops.gp_field import gp_field, gp_weights
from bayesian_ode_tpu_torch.ops.mlp_dopri5 import mlp_field
from bayesian_ode_tpu_torch.ops.spiral_dopri5 import spiral_field
from bayesian_ode_tpu_torch.ops.svgd_phi import svgd_phi, svgd_phi_reference
from bayesian_ode_tpu_torch.samplers import stein

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (its replay of a solve's own records)

pytestmark = pytest.mark.cuda

C = 200                      # 3 full blocks of 64 and a ragged one

# every library these tests build, at the small shapes and the wide ones
# (GP at 7x7 and 8x8 inducing grids, MLP at N = 9 and 16, the spiral at
# N = 9): built together by the first fixture, one nvcc per source
LIBRARIES = [
    ("gp_dopri5", (5, 36)), ("gp_dopri5", (3, 36)), ("gp_dopri5", (5, 49)),
    ("gp_dopri5", (5, 64)),
    ("gp_rk4", (5, 36)), ("gp_rk4", (3, 36)), ("gp_rk4", (5, 49)),
    ("gp_rk4", (5, 64)),
    ("gp_dopri5_step", (5, 36)), ("gp_dopri5_step", (5, 49)),
    ("gp_dopri5_step", (5, 64)),
    ("mlp_rk4", (5, 20)), ("mlp_rk4", (5, 32)), ("mlp_rk4", (9, 32)),
    ("mlp_rk4", (16, 32)),
    ("mlp_dopri5", (5, 20)), ("mlp_dopri5", (5, 32)),
    ("mlp_dopri5", (9, 32)), ("mlp_dopri5", (16, 32)),
    ("spiral_dopri5", (5, 50)), ("spiral_dopri5", (5, 20)),
    ("spiral_dopri5", (9, 6)), ("spiral_dopri5", (16, 50)),
    ("fhn_dopri5", (5,)), ("fhn_dopri5", (32,)), ("fhn_dopri5", (40,)),
    ("svgd_phi", ()),
    *((family, shape) for family in ("mlp_rk4", "mlp_dopri5")
      for shape in ((5, 66), (5, 128), (32, 64), (17, 4))),
    *((family, shape) for family in ("gp_dopri5", "gp_rk4", "gp_dopri5_step")
      for shape in ((40, 36), (100, 16), (5, 225), (2, 1024))),
    ("spiral_dopri5", (20, 40)), ("spiral_dopri5", (16, 128)),
    ("spiral_dopri5", (32, 50)),
]


@pytest.fixture(scope="module")
def gp():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels build with nvcc for "
                    "sm_90a and run only there")
    dev = torch.device("cuda", 0)
    kr.full_f32_matmul()
    _build.build(LIBRARIES)
    data = make_dataset(seed=2, N=5, T=12, t_max=2.5, noise=0.05,
                        x0_scale=1.5)
    static = kr.make_static(kr.make_inducing_grid(data["Y"], M=6), sf=1.0,
                            ell=0.75)
    U0 = kr.init_params(data["Y"], data["t"], static, noise=0.05)["U"]
    f32 = torch.float32
    s32 = kr.GPVectorFieldStatic(
        Z=static.Z.to(dev, f32), KzzinvL=static.KzzinvL.to(dev, f32),
        Kzzinv=static.Kzzinv.to(dev, f32), sf=static.sf, ell=static.ell)
    gen = torch.Generator(device=dev).manual_seed(0)
    U = U0.to(dev, f32)[None] + 3e-3 * torch.randn(
        (C, 36, 2), generator=gen, device=dev, dtype=f32)
    A = torch.einsum("mk,ckd->cmd", s32.KzzinvL, U).contiguous()
    return {"A": A, "U": U, "x0": data["x0"].to(dev, f32),
            "ts": data["t"].to(dev, f32), "Y": data["Y"].to(dev, f32),
            "static": s32, "dev": dev, "data": data}


def _close_solves(ys_k, st_k, ys_p, st_p):
    scale = float(ys_p.abs().max())
    err = float((ys_k - ys_p).abs().max())
    assert err <= 1e-4 * scale, (err, scale)
    nfe_k = float(st_k["nfe"].float().mean())
    nfe_p = float(st_p["nfe"].float().mean())
    assert abs(nfe_k - nfe_p) <= 0.01 * nfe_p, (nfe_k, nfe_p)


# rtol=1e-5, where every step decision is truncation-driven.  At 1e-7 on
# this short horizon the 32-ulps floor binds and step counts follow the
# rounding of the error estimates (mean NFE measured 130.6 in the kernel
# and 127.9 in the plain version over these 200 chains); chip_smoke.py
# gates rtol=1e-7 at the main path's full shape, where the two agree to
# 0.02%.
@pytest.mark.parametrize("controller", ["i", "pi"])
def test_whole_solve_kernel_matches_plain(gp, controller):
    rtol, atol = 1e-5, 1e-7
    args = (gp["A"], gp["x0"], gp["ts"], gp["static"])
    before = _build.launch_counts["gp_dopri5_solve_whole"]
    ys_k, st_k = gp_dopri5_solve_whole(*args, rtol=rtol, atol=atol,
                                       controller=controller)
    assert _build.launch_counts["gp_dopri5_solve_whole"] == before + 1
    ys_p, st_p = gp_dopri5_solve_whole_plain(*args, rtol=rtol, atol=atol,
                                             controller=controller)
    torch.cuda.synchronize()
    assert ys_k.is_cuda and ys_k.shape == (12, C, 5, 2)
    _close_solves(ys_k, st_k, ys_p, st_p)
    assert st_k["reached_final_time"]
    assert torch.equal(ys_k[0], gp["x0"].expand(C, 5, 2))
    assert bool((st_k["nfe"] == 2 + 6 * (st_k["n_accepted"]
                                         + st_k["n_rejected"])).all())


def test_budget_exhaustion_holds_final_state(gp):
    ys, st = gp_dopri5_solve_whole(gp["A"], gp["x0"], gp["ts"],
                                   gp["static"], max_steps=5)
    torch.cuda.synchronize()
    assert not st["reached_final_time"]
    assert bool((st["n_accepted"] + st["n_rejected"] == 5).all())
    held = (ys == ys[-1][None]).all(dim=3).all(dim=2)          # (T, C)
    assert bool(held[-1].all())
    first = held.int().argmax(dim=0)
    assert bool((first >= 1).all())
    for c in range(C):
        assert bool(held[first[c]:, c].all())


@pytest.mark.parametrize("controller", ["i", "pi"])
def test_recording_forward_is_bit_equal_to_the_whole_solve(gp, controller):
    ys_whole, st = gp_dopri5_solve_whole(gp["A"], gp["x0"], gp["ts"],
                                         gp["static"], controller=controller)
    ys_rec = gp_dopri5_trajectory(gp["A"], gp["x0"], gp["ts"], gp["static"],
                                  controller=controller)
    torch.cuda.synchronize()
    assert torch.equal(ys_rec, ys_whole)


def test_replay_backward_matches_plain_and_autograd(gp):
    s = gp["static"]
    Z = s.Z.contiguous()
    x0b, f0, dt0 = _pack_initial(gp["A"], gp["x0"], Z, s.sf, s.ell, 1e-7,
                                 1e-9)
    field, w = gp_field(s.sf, s.ell), (gp["A"], Z)
    args = (x0b, f0, dt0, gp["ts"], 1e-7, 1e-9, 0.9, 10.0, 0.2, 100_000,
            "i")
    _, _, nacc, _, _, rec = fa.fwd(field, w, *args, record=True,
                                   store_steps=128)
    _, _, nacc_p, _, _, rec_p = fa.fwd_plain(field.make_rhs(w), *args,
                                             store_steps=128)
    g = torch.randn((12, C, 5, 2),
                    generator=torch.Generator(device=gp["dev"]).manual_seed(5),
                    device=gp["dev"])
    (Abar_k,), lbar_k = fa.bwd(field, w, gp["ts"], rec, nacc, g)
    (Abar_p,), lbar_p = fa.bwd_plain(field.make_rhs(w),
                                     field.make_rhs_vjp(w), w[:1], gp["ts"],
                                     rec_p, nacc_p, g)
    A = gp["A"].clone().requires_grad_(True)
    ys = gp_dopri5_trajectory_plain(A, gp["x0"], gp["ts"], s)
    (Abar_ag,) = torch.autograd.grad((ys * g).sum(), [A])
    torch.cuda.synchronize()

    def max_rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    assert max_rel(Abar_k, Abar_p) <= 1e-3
    assert max_rel(lbar_k, lbar_p) <= 1e-3
    assert max_rel(Abar_k, Abar_ag) <= 1e-3


def test_record_overflow_raises(gp):
    with pytest.raises(RuntimeError, match="store_steps"):
        gp_dopri5_trajectory(gp["A"], gp["x0"], gp["ts"], gp["static"],
                             store_steps=4)


def test_fused_potential_on_the_card_matches_the_cpu(gp):
    """The sampler's potential through K2/K3 on the card against the same
    potential through the plain versions on the CPU."""
    gen = torch.Generator(device=gp["dev"]).manual_seed(1)
    logsn = -3.0 + 0.01 * torch.randn((C, 2), generator=gen,
                                      device=gp["dev"])
    out = []
    for dev in (gp["dev"], torch.device("cpu")):
        s = gp["static"]
        static = s._replace(Z=s.Z.to(dev), KzzinvL=s.KzzinvL.to(dev),
                            Kzzinv=s.Kzzinv.to(dev))
        pot = make_fused_gp_potential_dopri5(static, gp["x0"].to(dev),
                                             gp["ts"].to(dev),
                                             gp["Y"].to(dev))
        params = {"U": gp["U"].detach().to(dev).requires_grad_(True),
                  "logsn": logsn.detach().to(dev).requires_grad_(True)}
        val = pot(params)
        val.sum().backward()
        out.append((val.detach().cpu(), params["U"].grad.cpu(),
                    params["logsn"].grad.cpu()))
    (v_k, gU_k, gl_k), (v_p, gU_p, gl_p) = out
    torch.testing.assert_close(v_k, v_p, rtol=1e-4, atol=0)
    assert float((gU_k - gU_p).abs().max() / gU_p.abs().max()) <= 1e-3
    assert float((gl_k - gl_p).abs().max() / gl_p.abs().max()) <= 1e-3


C_RK4, H_RK4 = 256, 20


def _max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_gp_rk4_kernels_match_plain(gp):
    s = gp["static"]
    gen = torch.Generator(device=gp["dev"]).manual_seed(2)
    U = gp["U"][:1] + 3e-3 * torch.randn((C_RK4, 36, 2), generator=gen,
                                         device=gp["dev"])
    A = torch.einsum("mk,ckd->cmd", s.KzzinvL, U).contiguous()
    Z, x0 = s.Z.contiguous(), gp["x0"].contiguous()
    dts = torch.diff(gp["ts"]).contiguous()
    before = dict(_build.launch_counts)
    ys_k = gp_rk4.gp_rk4_fwd(A, Z, x0, dts, s.sf, s.ell)
    ys_p = gp_rk4.gp_rk4_fwd_plain(A, Z, x0, dts, s.sf, s.ell)
    g = torch.randn(ys_k.shape, generator=gen, device=gp["dev"])
    Abar_k, lbar_k = gp_rk4.gp_rk4_bwd(A, Z, ys_k, g, dts, s.sf, s.ell)
    Abar_p, lbar_p = gp_rk4.gp_rk4_bwd_plain(A, Z, ys_p, g, dts, s.sf, s.ell)
    Ar = A.clone().requires_grad_(True)
    (Abar_ag,) = torch.autograd.grad(
        (gp_rk4.gp_rk4_fwd_plain(Ar, Z, x0, dts, s.sf, s.ell) * g).sum(),
        [Ar])
    torch.cuda.synchronize()
    assert _build.launch_counts["gp_rk4_fwd"] == before["gp_rk4_fwd"] + 1
    assert _build.launch_counts["gp_rk4_bwd"] == before["gp_rk4_bwd"] + 1
    assert ys_k.shape == (12, C_RK4, 5, 2)
    assert float((ys_k - ys_p).abs().max()) <= 1e-5 * float(
        ys_p.abs().max())
    assert _max_rel(Abar_k, Abar_p) <= 1e-5
    assert _max_rel(lbar_k, lbar_p) <= 1e-5
    assert _max_rel(Abar_k, Abar_ag) <= 1e-5


# the kernel's length scale past an 8 x 8 grid: over this data the 0.75
# kernel matrix of a 15 x 15 or 32 x 32 grid is not positive definite in
# float64 (its Cholesky fails), while these leave smallest eigenvalues of
# 5.5e-4 and 3.8e-5
GRID_ELL = {15: 0.3, 32: 0.15}


def _gp_grid(gp, grid):
    """(static on the card, U's gradient-matched start (grid^2, 2)) of the
    GP problem on a grid x grid inducing grid."""
    if grid == 6:
        return gp["static"], gp["U"][0]
    data, dev, f32 = gp["data"], gp["dev"], torch.float32
    static = kr.make_static(kr.make_inducing_grid(data["Y"], M=grid), sf=1.0,
                            ell=GRID_ELL.get(grid, 0.75))
    U0 = kr.init_params(data["Y"], data["t"], static, noise=0.05)["U"]
    s32 = kr.GPVectorFieldStatic(
        Z=static.Z.to(dev, f32), KzzinvL=static.KzzinvL.to(dev, f32),
        Kzzinv=static.Kzzinv.to(dev, f32), sf=static.sf, ell=static.ell)
    return s32, U0.to(dev, f32)


def _gp_point_case(gp, chains, points, seed, grid=6):
    """A (chains, grid^2, 2) from the jittered start and x0 of `points`
    trajectory points (past the data's 5, on _line_x0's two lines): 3
    points build the GP libraries at GP_N = 3, a 7x7 or 8x8 grid at M = 49
    or 64."""
    s, U0 = _gp_grid(gp, grid)
    gen = torch.Generator(device=gp["dev"]).manual_seed(seed)
    U = U0[None] + 3e-3 * torch.randn((chains, grid * grid, 2),
                                      generator=gen, device=gp["dev"])
    A = torch.einsum("mk,ckd->cmd", s.KzzinvL, U).contiguous()
    x0 = gp["x0"][:points] if points <= 5 else _line_x0(gp, points)
    return A, s.Z.contiguous(), x0.contiguous(), gen


# K1, K2, K3 GP, K4 and K5 run one thread per trajectory point, N
# consecutive lanes a chain (csrc/gp_field.cuh, GPPoint): 257 chains leave
# the last warp and block ragged, 3 points build GP_N = 3, 10 chains a
# warp, and the 7x7 and 8x8 inducing grids (M = 49, 64) put the blocks'
# buffers past 48 KB of shared memory (dynamic: K3 at M = 49, K3 and K5 at
# M = 64).  Past them, GPWidePoint (csrc/gp_wide_field.cuh): N = 40 (two
# warps a chain, the second with 8 points) and N = 100 (four, the last with
# 4) on 6x6 and 4x4 grids, every kernel; N = 5 on a 15x15 grid (M = 225:
# K3 and K5, 24 chains a block, their Abar one column a chain), and N = 2
# on a 32x32 grid (M = 1,024: every kernel, 13 chains a one-warp block).
POINT_CASES = [(257, 5, 6), (257, 3, 6), (257, 5, 7), (257, 5, 8),
               (257, 40, 6), (60, 100, 4), (257, 5, 15), (100, 2, 32)]


@pytest.mark.parametrize("controller", ["i", "pi"])
@pytest.mark.parametrize("chains,points,grid", POINT_CASES)
def test_gp_solves_one_thread_a_point(gp, chains, points, grid, controller):
    """K1 and K2 against the plain forward at rtol=1e-5 (the gate of
    test_whole_solve_kernel_matches_plain), and K2 bit-equal to K1: the
    chain's threads sum the error norm by shuffles (norm_sums), so every
    one of them takes the chain's steps."""
    s = gp["static"]
    A, Z, x0, _ = _gp_point_case(gp, chains, points, 8, grid)
    field, w, ts = gp_field(s.sf, s.ell), (A, Z), gp["ts"]
    rtol, atol = 1e-5, 1e-7
    x0b, f0, dt0 = ff._start(field, w, x0, rtol, atol)
    args = (x0b, f0, dt0, ts, rtol, atol, 0.9, 10.0, 0.2, 100_000,
            controller)
    before = dict(_build.launch_counts)
    whole = fa.fwd(field, w, *args, record=False)
    rec = fa.fwd(field, w, *args, record=True, store_steps=128)
    ys_p, nfe_p, *_ = fa.fwd_plain(field.make_rhs(w), *args)
    torch.cuda.synchronize()
    for kind in ("solve_whole", "fwd_record"):
        assert _build.launch_counts[f"gp_dopri5_{kind}"] == \
            before[f"gp_dopri5_{kind}"] + 1, kind
    for a, b in zip(whole[:5], rec[:5]):
        assert torch.equal(a, b)
    ys, nfe, nacc, nrej = whole[:4]
    assert ys.shape == (12, chains, points, 2)
    assert torch.equal(ys[0], x0.expand(chains, points, 2))
    assert bool((nfe == 2 + 6 * (nacc + nrej)).all())
    assert int(rec[2].max()) <= 128
    _close_solves(ys, {"nfe": nfe}, ys_p, {"nfe": nfe_p})


@pytest.mark.parametrize("chains,points,grid", POINT_CASES)
def test_gp_rk4_forward_one_thread_a_point(gp, chains, points, grid):
    """K4 (one thread a point, GPPoint's one-point rhs through
    rk4_step<2>) against its plain version, at the rk4 gate."""
    s = gp["static"]
    A, Z, x0, _ = _gp_point_case(gp, chains, points, 9, grid)
    dts = torch.diff(gp["ts"]).contiguous()
    before = _build.launch_counts["gp_rk4_fwd"]
    ys_k = gp_rk4.gp_rk4_fwd(A, Z, x0, dts, s.sf, s.ell)
    ys_p = gp_rk4.gp_rk4_fwd_plain(A, Z, x0, dts, s.sf, s.ell)
    torch.cuda.synchronize()
    assert _build.launch_counts["gp_rk4_fwd"] == before + 1
    assert ys_k.shape == (12, chains, points, 2)
    assert torch.equal(ys_k[0], x0.expand(chains, points, 2))
    assert bool(torch.isfinite(ys_k).all())
    assert float((ys_k - ys_p).abs().max()) <= 1e-5 * float(
        ys_p.abs().max())


@pytest.mark.parametrize("chains,points,grid", POINT_CASES)
def test_gp_rk4_backward_one_thread_a_point(gp, chains, points, grid):
    s = gp["static"]
    A, Z, x0, gen = _gp_point_case(gp, chains, points, 6, grid)
    dts = torch.diff(gp["ts"]).contiguous()
    ys = gp_rk4.gp_rk4_fwd(A, Z, x0, dts, s.sf, s.ell)
    g = torch.randn(ys.shape, generator=gen, device=gp["dev"])
    before = _build.launch_counts["gp_rk4_bwd"]
    Abar_k, lbar_k = gp_rk4.gp_rk4_bwd(A, Z, ys, g, dts, s.sf, s.ell)
    Abar_p, lbar_p = gp_rk4.gp_rk4_bwd_plain(A, Z, ys, g, dts, s.sf, s.ell)
    Ar = A.clone().requires_grad_(True)
    (Abar_ag,) = torch.autograd.grad(
        (gp_rk4.gp_rk4_fwd_plain(Ar, Z, x0, dts, s.sf, s.ell) * g).sum(),
        [Ar])
    torch.cuda.synchronize()
    assert _build.launch_counts["gp_rk4_bwd"] == before + 1
    assert lbar_k.shape == (chains, points, 2)
    assert bool(torch.isfinite(Abar_k).all() and torch.isfinite(lbar_k).all())
    assert _max_rel(Abar_k, Abar_p) <= 1e-5
    assert _max_rel(lbar_k, lbar_p) <= 1e-5
    assert _max_rel(Abar_k, Abar_ag) <= 1e-5


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
@pytest.mark.parametrize("chains,points,grid", POINT_CASES)
def test_gp_replay_backward_one_thread_a_point(gp, chains, points, grid,
                                               method):
    """K3 GP against the plain replay of the kernel's own records (the
    same step mesh), at the same-mesh gate of the other instances."""
    s = gp["static"]
    A, Z, x0, gen = _gp_point_case(gp, chains, points, 7, grid)
    field, w, ts = gp_field(s.sf, s.ell), (A, Z), gp["ts"]
    x0b, f0, dt0 = ff._start(field, w, x0, 1e-7, 1e-9)
    ys, _, nacc, _, _, rec = fa.fwd(field, w, x0b, f0, dt0, ts, 1e-7, 1e-9,
                                    0.9, 10.0, 0.2, 100_000, "i",
                                    record=True, store_steps=128,
                                    method=method)
    g = torch.randn(ys.shape, generator=gen, device=gp["dev"])
    before = _build.launch_counts[f"gp_{method}_bwd"]
    (Abar_k,), lbar_k = fa.bwd(field, w, ts, rec, nacc, g, method=method)
    (Abar_p,), lbar_p = fa.bwd_plain(field.make_rhs(w), field.make_rhs_vjp(w),
                                     w[:1], ts, rec, nacc, g,
                                     fa.TABLEAUS[method])
    torch.cuda.synchronize()
    assert _build.launch_counts[f"gp_{method}_bwd"] == before + 1
    assert lbar_k.shape == (chains, points, 2)
    assert bool(torch.isfinite(Abar_k).all() and torch.isfinite(lbar_k).all())
    assert _max_rel(Abar_k, Abar_p) <= 1e-4
    assert _max_rel(lbar_k, lbar_p) <= 1e-4


@pytest.mark.parametrize("chains,hidden", [(C_RK4, H_RK4), (257, H_RK4),
                                           (C_RK4, 32)])
def test_mlp_rk4_kernels_match_plain(gp, chains, hidden):
    """K6/K7 at H=20 (lanes past H hold zeros), at a chain count that
    leaves the last block of 4 warps one chain, and at the driver's width
    H=32."""
    dev = gp["dev"]
    gen = torch.Generator(device=dev).manual_seed(3)
    sizes = [2, hidden, hidden, 2]
    w = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w += [torch.rand((chains, a, b), generator=gen, device=dev) - 0.5,
              0.1 * torch.randn((chains, b), generator=gen, device=dev)]
    _check_mlp_rk4_kernels(gp, tuple(w), gp["x0"], gen)


def _check_mlp_rk4_kernels(gp, w, x0, gen):
    """K6/K7 against their plain versions and autograd, at the rk4 gate."""
    dev = gp["dev"]
    x0, dts = x0.contiguous(), torch.diff(gp["ts"]).contiguous()
    before = dict(_build.launch_counts)
    ys_k = mlp_rk4.mlp_rk4_fwd(w, x0, dts)
    ys_p = mlp_rk4.mlp_rk4_fwd_plain(w, x0, dts)
    g = torch.randn(ys_k.shape, generator=gen, device=dev)
    wbar_k, lbar_k = mlp_rk4.mlp_rk4_bwd(w, ys_k, g, dts)
    wbar_p, lbar_p = mlp_rk4.mlp_rk4_bwd_plain(w, ys_p, g, dts)
    wr = [x.clone().requires_grad_(True) for x in w]
    wbar_ag = torch.autograd.grad(
        (mlp_rk4.mlp_rk4_fwd_plain(wr, x0, dts) * g).sum(), wr)
    torch.cuda.synchronize()
    assert _build.launch_counts["mlp_rk4_fwd"] == before["mlp_rk4_fwd"] + 1
    assert _build.launch_counts["mlp_rk4_bwd"] == before["mlp_rk4_bwd"] + 1
    assert ys_k.shape == (len(gp["ts"]),) + tuple(lbar_k.shape)
    assert float((ys_k - ys_p).abs().max()) <= 1e-5 * float(
        ys_p.abs().max())
    for k, p, ag in zip(wbar_k, wbar_p, wbar_ag):
        assert _max_rel(k, p) <= 1e-5
        assert _max_rel(k, ag) <= 1e-5
    assert _max_rel(lbar_k, lbar_p) <= 1e-5


def test_mlp_rk4_wider_than_a_warp_raises(gp):
    """Past the kernels' widths (H = 129 at N = 5, H = 65 at N = 17) the
    wrapper raises before any build; the wide instances' blocks are the
    shape check's arithmetic (dynamic shared memory, one warp a block)."""
    dev = gp["dev"]
    for H, x0 in ((129, gp["x0"]), (65, _line_x0(gp, 17))):
        w = (torch.zeros(8, 2, H, device=dev), torch.zeros(8, H, device=dev),
             torch.zeros(8, H, H, device=dev), torch.zeros(8, H, device=dev),
             torch.zeros(8, H, 2, device=dev), torch.zeros(8, 2, device=dev))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mlp_rk4.mlp_rk4_fwd(w, x0, torch.diff(gp["ts"]))
        assert ("mlp_rk4", (x0.shape[0], H)) not in _build._LIBS
    for family, shape in LIBRARIES:
        if family.startswith("mlp") and _build.mlp_wide(shape):
            want = _build.smem_bytes(family, shape)
            for kind, sizes in _build.built_smem(family, shape).items():
                assert sizes == [want[kind]] * len(sizes), (family, shape)


def _spiral_weights(gen, chains, H):
    """The spiral's start weights (N(0, 0.1) and zero biases, models/
    spiral.py), jittered by 0.005 per chain."""
    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    return (0.1 * randn(1, 2, H) + 0.005 * randn(chains, 2, H),
            0.005 * randn(chains, H),
            0.1 * randn(1, H, 2) + 0.005 * randn(chains, H, 2),
            0.005 * randn(chains, 2))


def _mlp_weights(gen, chains, H):
    """The MLP field's uniform(-0.5, 0.5) weights and biases of standard
    deviation 0.1."""
    dev = gen.device

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev) - 0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    return (uniform(chains, 2, H), 0.1 * randn(chains, H),
            uniform(chains, H, H), 0.1 * randn(chains, H),
            uniform(chains, H, 2), 0.1 * randn(chains, 2))


def _driver_mlp_weights(gen, chains, H=32, scale=1.0):
    """The driver's start weights of the MLP 2-H-H-2 (uniform(-0.5, 0.5),
    zero biases; the H->H and H->2 weights times `scale`), jittered by
    0.005 per chain."""
    dev = gen.device
    params = init_mlp(torch.Generator().manual_seed(0), [2, H, H, 2],
                      dtype=torch.float32)
    leaves = [x for layer in params for x in (layer["w"], layer["b"])]
    return tuple(((scale if i in (2, 4) else 1.0) * x.to(dev)[None]
                  + 0.005 * torch.randn((chains, *x.shape), generator=gen,
                                        device=dev)).contiguous()
                 for i, x in enumerate(leaves))


def _adaptive_case(gp, case):
    """(field, weights, method) of one field/tableau instance at C chains:
    the driver's start weights, jittered per chain."""
    dev = gp["dev"]
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    if case == "gp_tsit5":
        s = gp["static"]
        return gp_field(s.sf, s.ell), (gp["A"], s.Z.contiguous()), "tsit5"
    if case.startswith("mlp"):
        return mlp_field(H_RK4), _mlp_weights(gen, C, H_RK4), \
            "tsit5" if case == "mlp_tsit5" else "dopri5"
    if case.startswith("spiral"):
        return spiral_field(), _spiral_weights(gen, C, int(case[7:])), \
            "dopri5"
    w = tuple(v + 0.05 * randn(C) for v in (0.2, 0.2, 3.0))
    return fhn_field(), w, "dopri5"


@pytest.mark.parametrize("case", ["gp_tsit5", "mlp", "mlp_tsit5",
                                  "spiral_50", "spiral_20", "fhn"])
def test_adaptive_field_kernels_match_plain(gp, case):
    """K2 and K3 of each new field/tableau instance against their plain
    versions; the forward without records is bit-equal to the recording
    one.  The two forwards' step meshes differ by rounding, and at
    rtol=1e-5 the frozen-mesh gradients of two meshes differ by up to
    1.4e-3 max-rel (MLP, measured on the card), so K3 is held on the same
    mesh: against the plain replay of its own records, and the plain
    replay of the plain forward's records against autograd through that
    forward (measured 3e-7 to 1.2e-6 apart on the CPU), each within 1e-4.
    """
    field, w, method = _adaptive_case(gp, case)
    _check_adaptive_kernels(gp, field, w, method, gp["x0"], gp["ts"])


def _check_adaptive_kernels(gp, field, w, method, x0, ts, nfe_tol=0.01):
    """K2 (with and without records) and K3 of one field instance against
    their plain versions at rtol=1e-5, as test_adaptive_field_kernels_
    match_plain says; mean NFE within nfe_tol."""
    w = tuple(x.contiguous() for x in w)
    rtol, atol = 1e-5, 1e-7
    x0b, f0, dt0 = ff._start(field, w, x0, rtol, atol)
    args = (x0b, f0, dt0, ts, rtol, atol, 0.9, 10.0, 0.2, 100_000, "i")
    tableau = fa.TABLEAUS[method]
    before = dict(_build.launch_counts)
    ys_k, nfe_k, nacc_k, _, _, rec_k = fa.fwd(field, w, *args, record=True,
                                              store_steps=128, method=method)
    ys_w, nfe_w, _, _, _, _ = fa.fwd(field, w, *args, record=False,
                                     method=method)
    ys_p, nfe_p, nacc_p, _, _, rec_p = fa.fwd_plain(
        field.make_rhs(w), *args, store_steps=128, tableau=tableau)
    g = torch.randn(ys_k.shape, generator=torch.Generator(
        device=gp["dev"]).manual_seed(5), device=gp["dev"])
    wbar_k, lbar_k = fa.bwd(field, w, ts, rec_k, nacc_k, g, method=method)
    n = field.n_wbar
    rhs, vjp = field.make_rhs(w), field.make_rhs_vjp(w)
    wbar_kp, lbar_kp = fa.bwd_plain(rhs, vjp, w[:n], ts, rec_k, nacc_k, g,
                                    tableau)
    wbar_p, _ = fa.bwd_plain(rhs, vjp, w[:n], ts, rec_p, nacc_p, g, tableau)
    wr = [x.clone().requires_grad_(True) for x in w[:n]]
    ys_ag = ff.fused_dopri5_trajectory_plain(field, tuple(wr) + w[n:], x0,
                                             ts, rtol=rtol, atol=atol,
                                             method=method)
    wbar_ag = torch.autograd.grad((ys_ag * g).sum(), wr)
    torch.cuda.synchronize()
    prefix = f"{field.name}_{method}_"
    for kind in ("fwd_record", "solve_whole", "bwd"):
        assert _build.launch_counts[prefix + kind] == \
            before[prefix + kind] + 1, kind
    assert torch.equal(ys_w, ys_k) and torch.equal(nfe_w, nfe_k)
    assert bool(torch.isfinite(ys_k).all())
    scale = float(ys_p.abs().max())
    assert float((ys_k - ys_p).abs().max()) <= 1e-4 * scale
    mk, mp = float(nfe_k.float().mean()), float(nfe_p.float().mean())
    assert abs(mk - mp) <= nfe_tol * mp, (mk, mp)
    for k, kp, p, a in zip(wbar_k, wbar_kp, wbar_p, wbar_ag):
        assert bool(torch.isfinite(k).all())
        assert _max_rel(k, kp) <= 1e-4
        assert _max_rel(p, a) <= 1e-4
    assert _max_rel(lbar_k, lbar_kp) <= 1e-4


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
@pytest.mark.parametrize("hidden", [50, 20])
def test_spiral_replay_backward_one_component_a_lane(gp, hidden, method):
    """Spiral K3 (one state component a lane, the stage points' tanh values
    kept in shared memory, csrc/spiral_field.cuh) at 257 chains, a last
    block of one warp, under each tableau: against the plain replay of the
    kernel's own records (the same step mesh).  At these start weights the
    solves are 4-5 steps and their rejections follow the rounding of the
    error estimates (a float64 solve differs from either float32 one on
    about half the chains), so K2 is held to the plain forward at DOPRI5
    in test_adaptive_field_kernels_match_plain and at full size in
    chip_smoke.py, not here."""
    dev, chains = gp["dev"], 257
    gen = torch.Generator(device=dev).manual_seed(13)
    w = tuple(x.contiguous() for x in _spiral_weights(gen, chains, hidden))
    field, ts = spiral_field(), gp["ts"]
    x0b, f0, dt0 = ff._start(field, w, gp["x0"], 1e-5, 1e-7)
    args = (x0b, f0, dt0, ts, 1e-5, 1e-7, 0.9, 10.0, 0.2, 100_000, "i")
    before = dict(_build.launch_counts)
    ys, nfe, nacc, _, _, rec = fa.fwd(field, w, *args, record=True,
                                      store_steps=128, method=method)
    ys_w, nfe_w, *_ = fa.fwd(field, w, *args, record=False, method=method)
    g = torch.randn(ys.shape, generator=gen, device=dev)
    wbar_k, lbar_k = fa.bwd(field, w, ts, rec, nacc, g, method=method)
    wbar_p, lbar_p = fa.bwd_plain(field.make_rhs(w), field.make_rhs_vjp(w),
                                  w, ts, rec, nacc, g, fa.TABLEAUS[method])
    torch.cuda.synchronize()
    for kind in ("fwd_record", "solve_whole", "bwd"):
        assert _build.launch_counts[f"spiral_{method}_{kind}"] == \
            before[f"spiral_{method}_{kind}"] + 1, kind
    assert torch.equal(ys_w, ys) and torch.equal(nfe_w, nfe)
    assert bool(torch.isfinite(ys).all())
    assert lbar_k.shape == (chains, 5, 2)
    for k, p in zip(wbar_k, wbar_p):
        assert bool(torch.isfinite(k).all())
        assert _max_rel(k, p) <= 1e-4
    assert _max_rel(lbar_k, lbar_p) <= 1e-4


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
@pytest.mark.parametrize("hidden", [20, 32])
def test_mlp_solves_one_component_a_lane(gp, hidden, method):
    """MLP K2 (one state component a lane, W2 in registers, the error norm
    gathered from lanes 0..2N-1: MLPDopri5Fwd in csrc/mlp_field.cuh) at 257
    chains, a last block of one warp, at H=20 (lanes past H hold zeros) and
    H=32, under each tableau: within 1e-4 * max|y| of the plain forward
    with mean NFE within 1%, and the solve with records bit-equal to the
    one without.  At rtol=1e-5 / atol=1e-7, as the other small-shape
    solves here: above the 32-ulp tolerance floor, where rounding moves a
    step count less than at the driver's rtol=1e-7 (chip_smoke.py holds K2
    there, averaged over 10,112 chains)."""
    dev, chains, rtol, atol = gp["dev"], 257, 1e-5, 1e-7
    gen = torch.Generator(device=dev).manual_seed(14)
    w = tuple(x.contiguous() for x in _mlp_weights(gen, chains, hidden))
    field, ts = mlp_field(hidden), gp["ts"]
    x0b, f0, dt0 = ff._start(field, w, gp["x0"], rtol, atol)
    args = (x0b, f0, dt0, ts, rtol, atol, 0.9, 10.0, 0.2, 100_000, "i")
    before = dict(_build.launch_counts)
    out_k = fa.fwd(field, w, *args, record=True, store_steps=128,
                   method=method)
    out_w = fa.fwd(field, w, *args, record=False, method=method)
    ys_p, nfe_p, *_ = fa.fwd_plain(field.make_rhs(w), *args,
                                   store_steps=128,
                                   tableau=fa.TABLEAUS[method])
    torch.cuda.synchronize()
    for kind in ("fwd_record", "solve_whole"):
        assert _build.launch_counts[f"mlp_{method}_{kind}"] == \
            before[f"mlp_{method}_{kind}"] + 1, kind
    for k, kw in zip(out_k[:5], out_w[:5]):
        assert torch.equal(k, kw)
    ys_k, nfe_k = out_k[:2]
    assert ys_k.shape == (len(ts), chains, 5, 2)
    assert bool(torch.isfinite(ys_k).all())
    assert float((ys_k - ys_p).abs().max()) <= 1e-4 * float(
        ys_p.abs().max())
    mk, mp = float(nfe_k.float().mean()), float(nfe_p.float().mean())
    assert abs(mk - mp) <= 0.01 * mp, (mk, mp)


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_mlp_replay_backward_at_the_driver_width(gp, method):
    """MLP K3 at H=32 (every lane a hidden unit) from the driver's start
    weights, jittered per chain, under each tableau: held against the plain
    replay of the kernel's own records, which fixes the step mesh (K2's
    short solves here differ from the plain forward's by a rejected step on
    some chains; chip_smoke.py holds K2 at the full shape)."""
    dev = gp["dev"]
    gen = torch.Generator(device=dev).manual_seed(12)
    w = _driver_mlp_weights(gen, C)
    field, ts = mlp_field(32), gp["ts"]
    x0b, f0, dt0 = ff._start(field, w, gp["x0"], 1e-5, 1e-7)
    before = dict(_build.launch_counts)
    ys, _, nacc, _, _, rec = fa.fwd(field, w, x0b, f0, dt0, ts, 1e-5, 1e-7,
                                    0.9, 10.0, 0.2, 100_000, "i",
                                    record=True, store_steps=128,
                                    method=method)
    g = torch.randn(ys.shape, generator=gen, device=dev)
    wbar_k, lbar_k = fa.bwd(field, w, ts, rec, nacc, g, method=method)
    wbar_p, lbar_p = fa.bwd_plain(field.make_rhs(w), field.make_rhs_vjp(w),
                                  w, ts, rec, nacc, g, fa.TABLEAUS[method])
    torch.cuda.synchronize()
    assert _build.launch_counts[f"mlp_{method}_bwd"] == \
        before[f"mlp_{method}_bwd"] + 1
    assert bool(torch.isfinite(ys).all())
    for k, p in zip(wbar_k, wbar_p):
        assert bool(torch.isfinite(k).all())
        assert _max_rel(k, p) <= 1e-4
    assert _max_rel(lbar_k, lbar_p) <= 1e-4


# Past N = 8 the MLP and spiral fields' 2N sums are one 32-wide
# reduce-scatter (warp_sum32), and K7's and MLP K3's blocks take fewer
# warps (csrc/mlp_field.cuh); start points on two lines, as the JAX
# package's N = 9 case (tests/test_fused_field.py).
WIDE_POINTS = (9, 16)


def _line_x0(gp, n):
    return torch.stack([torch.linspace(-1.5, 2.0, n),
                        torch.linspace(0.8, -0.9, n)], dim=-1).to(gp["dev"])


@pytest.mark.parametrize("points", WIDE_POINTS)
def test_mlp_rk4_kernels_past_eight_points(gp, points):
    """K6/K7 at N = 9 and 16, H = 32."""
    gen = torch.Generator(device=gp["dev"]).manual_seed(17)
    _check_mlp_rk4_kernels(gp, _mlp_weights(gen, C, 32), _line_x0(gp, points),
                           gen)


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
@pytest.mark.parametrize("points", WIDE_POINTS)
def test_mlp_adaptive_kernels_past_eight_points(gp, points, method):
    """MLP K2 and K3 at N = 9 and 16, H = 32, under each tableau, from the
    driver's start weights (with _mlp_weights' biases the trajectories of
    these start points grow to |y| ~ 70 by t = 2.5, where exp overflows in
    the plain field's ELU and autograd through it gives NaN)."""
    gen = torch.Generator(device=gp["dev"]).manual_seed(15)
    _check_adaptive_kernels(gp, mlp_field(32), _driver_mlp_weights(gen, C),
                            method, _line_x0(gp, points), gp["ts"])


# Past one warp (csrc/mlp_wide_field.cuh, one warp and block a chain, W2
# in shared memory): H = 66 (three units a lane, the last one past H on
# most lanes) and 128 (four), N = 32 at H = 64 (one point a lane, two
# units) and N = 17 at H = 4 (one point a lane, lanes past N idle).
MLP_WIDE = [(5, 66), (5, 128), (32, 64), (17, 4)]
# The driver's seed-0 start at H = 64 is an expansive field (its N = 32
# trajectories reach |y| 3.4e4 by t = 6 over 10,112 chains; autograd
# through the plain forward overflows there): at N = 32 its H->H and H->2
# layers are scaled by 32/H, as in chip_smoke.py phase 40.
WIDE_START_SCALE = {(32, 64): 0.5}


def _wide_case(gp, gen, points, hidden):
    x0 = gp["x0"] if points == 5 else _line_x0(gp, points)
    return x0, _driver_mlp_weights(
        gen, C, hidden, WIDE_START_SCALE.get((points, hidden), 1.0))


@pytest.mark.parametrize("points,hidden", MLP_WIDE)
def test_mlp_rk4_kernels_past_one_warp(gp, points, hidden):
    """K6/K7 of the wide field against plain and autograd, from the
    driver's start weights."""
    gen = torch.Generator(device=gp["dev"]).manual_seed(18)
    x0, w = _wide_case(gp, gen, points, hidden)
    _check_mlp_rk4_kernels(gp, w, x0, gen)


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
@pytest.mark.parametrize("points,hidden", MLP_WIDE)
def test_mlp_adaptive_kernels_past_one_warp(gp, points, hidden, method):
    """MLP K2 and K3 of the wide field under each tableau, from the
    driver's start weights: K2 within 1e-4 max|y| of the plain version's
    step arithmetic replayed on its own records and within 1% of the
    plain solve's mean NFE, the solve without records bit-equal to it; K3
    within 1e-4 max-rel of the plain replay of the same records.  (At
    H = 66 the two float32 solves' step meshes part on some chains: their
    trajectories were 2.8e-4 max|y| apart at N = 5 on an H100, the mean
    NFE 0.1%, as the spiral's at N = 9 in chip_smoke.py phase 17.)  The
    N = 17, H = 4 solves take 3-4 steps, and the rounding of the field
    alone moves their mean NFE by about 1% (a correctly rounded field
    against the float32 plain one, on 200 such chains on the CPU: 0.9%
    DOPRI5, 1.3% TSIT5), so there the gate is the spiral's for its 3-4
    step solves, 2% (test_spiral_kernels_at_nine_points)."""
    dev = gp["dev"]
    gen = torch.Generator(device=dev).manual_seed(19)
    x0, w = _wide_case(gp, gen, points, hidden)
    nfe_tol = 0.02 if points > 16 and hidden <= 32 else 0.01
    field, ts, tableau = mlp_field(hidden), gp["ts"], fa.TABLEAUS[method]
    x0b, f0, dt0 = ff._start(field, w, x0, 1e-5, 1e-7)
    args = (x0b, f0, dt0, ts, 1e-5, 1e-7, 0.9, 10.0, 0.2, 100_000, "i")
    before = dict(_build.launch_counts)
    ys, nfe, nacc, _, _, rec = fa.fwd(field, w, *args, record=True,
                                      store_steps=128, method=method)
    ys_w, nfe_w, *_ = fa.fwd(field, w, *args, record=False, method=method)
    rhs, vjp = field.make_rhs(w), field.make_rhs_vjp(w)
    _, nfe_p, *_ = fa.fwd_plain(rhs, *args, store_steps=128, tableau=tableau)
    ys_r = chip_smoke.replay_dense_output(rhs, rec, nacc, x0b, ts,
                                          tableau)
    g = torch.randn(ys.shape, generator=gen, device=dev)
    wbar_k, lbar_k = fa.bwd(field, w, ts, rec, nacc, g, method=method)
    wbar_p, lbar_p = fa.bwd_plain(rhs, vjp, w, ts, rec, nacc, g, tableau)
    torch.cuda.synchronize()
    for kind in ("fwd_record", "solve_whole", "bwd"):
        assert _build.launch_counts[f"mlp_{method}_{kind}"] == \
            before[f"mlp_{method}_{kind}"] + 1, kind
    assert torch.equal(ys_w, ys) and torch.equal(nfe_w, nfe)
    assert bool(torch.isfinite(ys).all())
    assert float((ys - ys_r).abs().max()) <= 1e-4 * float(ys_r.abs().max())
    mk, mp = float(nfe.float().mean()), float(nfe_p.float().mean())
    assert abs(mk - mp) <= nfe_tol * mp, (mk, mp)
    for k, p in zip(wbar_k + (lbar_k,), wbar_p + (lbar_p,)):
        assert bool(torch.isfinite(k).all())
        assert _max_rel(k, p) <= 1e-4


def test_spiral_kernels_at_nine_points(gp):
    """Spiral K2/K3 at the JAX package's wide case: N = 9, H = 6, 6 output
    times to t = 1.2, rtol = 1e-5 (ROADMAP queue 3, fault 1, step 3).  The
    solves are 3-4 steps, so a rejection that follows the rounding of an
    error estimate moves the mean NFE visibly: the spiral's gate of
    chip_smoke.py, 2%."""
    gen = torch.Generator(device=gp["dev"]).manual_seed(16)
    ts = torch.linspace(0.0, 1.2, 6, device=gp["dev"])
    _check_adaptive_kernels(gp, spiral_field(), _spiral_weights(gen, C, 6),
                            "dopri5", _line_x0(gp, 9), ts, nfe_tol=0.02)


# The forwards that spread a chain's state over its threads (spiral K2:
# SpiralDopri5Fwd, one state component a lane; FHN K2 and K3: FHNPoint, one
# trajectory point a thread to N = 32, and FHNDopri5 past 32 points a
# chain):
# (field, N, H); the spiral at N = 9 on the JAX package's wide case (H = 6,
# 6 output times to t = 1.2).
SPREAD = [("spiral", 5, 50), ("spiral", 9, 6), ("spiral", 16, 50),
          ("fhn", 5, None), ("fhn", 32, None), ("fhn", 40, None)]


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
@pytest.mark.parametrize("name,points,hidden", SPREAD)
def test_spread_forwards_match_plain(gp, name, points, hidden, method):
    """K2 with and without records (and K3 on its records) against the
    plain versions at _check_adaptive_kernels' gates, the spiral's mean
    NFE within its 2% (its short solves' rejections follow the rounding of
    the error estimates), and a second launch of K2 bit-equal to the
    first: trajectories, counters, end times and the record rows each
    chain wrote."""
    dev = gp["dev"]
    gen = torch.Generator(device=dev).manual_seed(18)
    x0 = gp["x0"] if points == 5 else _line_x0(gp, points)
    ts = gp["ts"]
    if name == "spiral":
        field, w = spiral_field(), _spiral_weights(gen, C, hidden)
        if points == 9:
            ts = torch.linspace(0.0, 1.2, 6, device=dev)
    else:
        field = fhn_field()
        w = tuple(v + 0.05 * torch.randn(C, generator=gen, device=dev)
                  for v in (0.2, 0.2, 3.0))
    w = tuple(x.contiguous() for x in w)
    _check_adaptive_kernels(gp, field, w, method, x0, ts,
                            nfe_tol=0.02 if name == "spiral" else 0.01)
    x0b, f0, dt0 = ff._start(field, w, x0, 1e-5, 1e-7)
    args = (x0b, f0, dt0, ts, 1e-5, 1e-7, 0.9, 10.0, 0.2, 100_000, "i")
    first, again = (fa.fwd(field, w, *args, record=True, store_steps=128,
                           method=method) for _ in range(2))
    assert first[0].shape == (len(ts), C, points, 2)
    for a, b in zip(first[:5], again[:5]):
        assert torch.equal(a, b)
    # the record rows each chain wrote (the buffer is torch.empty)
    wrote = torch.arange(128, device=dev)[:, None, None] < first[2]
    assert torch.equal(torch.where(wrote, first[5], 0.0),
                       torch.where(wrote, again[5], 0.0))


# The spiral past one warp's lanes or 48 KB (csrc/spiral_wide_field.cuh,
# one warp and block a chain, ceil(2N/32) components a lane): two
# components a lane at (20, 40) and (32, 50), one at (16, 128), whose
# sweep's stage buffer takes 58,368 B.
SPIRAL_WIDE = [(20, 40), (16, 128), (32, 50)]


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
@pytest.mark.parametrize("points,hidden", SPIRAL_WIDE)
def test_spiral_kernels_past_one_warp(gp, points, hidden, method):
    """Spiral K2 and K3 of the wide field under each tableau, from the
    spiral's start weights (_spiral_weights): K2 within 1e-4 max|y| of the
    plain version's step arithmetic replayed on its own records, the solve
    without records and a second launch bit-equal to it; K3 within 1e-4
    max-rel of the plain replay of the same records; the mean NFE within
    2% of the plain solve's, or no further than the plain float32 solve's
    from the float64 solve's.  At H = 128 these 6-8 step solves' error
    estimates cancel to float32 rounding, so the kernel's and the plain
    version's step counts part on some chains (the two float32 solves
    each further from the float64 solve's mean NFE than from each other's),
    and their dense outputs by more than 1e-4 of max|y|, each as far from
    the float64 solve, while K2 agrees with the plain arithmetic on its
    own records (PERF.md §6)."""
    dev = gp["dev"]
    gen = torch.Generator(device=dev).manual_seed(18)
    w = tuple(x.contiguous()
              for x in _spiral_weights(gen, C, hidden))
    x0, ts, tab = _line_x0(gp, points), gp["ts"], fa.TABLEAUS[method]
    field = spiral_field()
    rhs, vjp = field.make_rhs(w), field.make_rhs_vjp(w)
    x0b, f0, dt0 = ff._start(field, w, x0, 1e-5, 1e-7)
    ctrl = (1e-5, 1e-7, 0.9, 10.0, 0.2, 100_000, "i")
    args = (x0b, f0, dt0, ts) + ctrl
    before = dict(_build.launch_counts)
    ys, nfe, nacc, _, _, rec = fa.fwd(field, w, *args, record=True,
                                      store_steps=128, method=method)
    again = fa.fwd(field, w, *args, record=True, store_steps=128,
                   method=method)
    ys_w, nfe_w, *_ = fa.fwd(field, w, *args, record=False, method=method)
    _, nfe_p, *_ = fa.fwd_plain(rhs, *args, store_steps=128, tableau=tab)
    w64 = tuple(x.double() for x in w)
    start64 = ff._start(field, w64, x0.double(), 1e-5, 1e-7)
    _, nfe64, *_ = fa.fwd_plain(field.make_rhs(w64), *start64, ts.double(),
                                *ctrl, tableau=tab)
    ys_r = chip_smoke.replay_dense_output(rhs, rec, nacc, x0b, ts, tab)
    g = torch.randn(ys.shape, generator=gen, device=dev)
    wbar_k, lbar_k = fa.bwd(field, w, ts, rec, nacc, g, method=method)
    wbar_p, lbar_p = fa.bwd_plain(rhs, vjp, w, ts, rec, nacc, g, tab)
    torch.cuda.synchronize()
    for kind, n in (("fwd_record", 2), ("solve_whole", 1), ("bwd", 1)):
        assert _build.launch_counts[f"spiral_{method}_{kind}"] == \
            before[f"spiral_{method}_{kind}"] + n, kind
    assert torch.equal(ys_w, ys) and torch.equal(nfe_w, nfe)
    for a, b in zip((ys, nfe, nacc), again[:3]):
        assert torch.equal(a, b)
    assert ys.shape == (12, C, points, 2) and bool(torch.isfinite(ys).all())
    assert float((ys - ys_r).abs().max()) <= 1e-4 * float(ys_r.abs().max())
    mk, mp, m64 = (float(x.float().mean()) for x in (nfe, nfe_p, nfe64))
    assert abs(mk - mp) <= 0.02 * mp or abs(mk - m64) <= abs(mp - m64), \
        (mk, mp, m64)
    for k, p in zip(wbar_k + (lbar_k,), wbar_p + (lbar_p,)):
        assert bool(torch.isfinite(k).all())
        assert _max_rel(k, p) <= 1e-4


@pytest.mark.parametrize("family,shape", LIBRARIES)
def test_reported_shared_memory_is_the_shape_checks_arithmetic(
        gp, family, shape):
    """Each library's *_smem entry points (ptxas's static bytes plus the
    launch's dynamic bytes, per kernel) against _build.smem_bytes, the
    arithmetic check_shape holds to the limits before any build."""
    built = _build.built_smem(family, shape)
    want = _build.smem_bytes(family, shape)
    assert set(built) == set(want)
    for kind, sizes in built.items():
        assert sizes == [want[kind]] * len(sizes), (kind, sizes, want)


@pytest.mark.parametrize("n,d", [(300, 5), (1000, 3), (130, 200),
                                 (4097, 74), (1, 74), (20, 74)])
def test_svgd_phi_kernel_matches_plain(gp, n, d):
    """Ragged particle counts against the 32-row and 32-column tiles, a
    width past the 96-feature chunk (three chunks), the SVGD path's 74
    features at a ragged count, one particle and fewer than a tile."""
    dev = gp["dev"]
    gen = torch.Generator(device=dev).manual_seed(n + d)
    X = torch.randn((n, d), generator=gen, device=dev)
    S = torch.randn((n, d), generator=gen, device=dev)
    gamma = torch.tensor(0.7 / d, device=dev)
    before = _build.launch_counts["svgd_phi"]
    got = svgd_phi(X, S, gamma)
    want = svgd_phi_reference(X, S, gamma)
    torch.cuda.synchronize()
    assert _build.launch_counts["svgd_phi"] == before + 1
    assert got.shape == (n, d) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)


def _svgd_ensemble(dev, n):
    """n particles of the GP posterior as chip_smoke.py's SVGD phase makes
    them (U and logsn of the gradient-matched start jittered by 0.005, 74
    parameters) and their scores from the fused rk4 potential (K4/K5)."""
    f32 = torch.float32
    data = make_dataset(seed=2, ode="vdp", N=5, T=60, t_max=6.0, noise=0.05,
                        x0_scale=1.5)
    static = kr.make_static(kr.make_inducing_grid(data["Y"], M=6), sf=1.0,
                            ell=0.75)
    p0 = kr.init_params(data["Y"], data["t"], static, noise=0.05)
    s32 = kr.GPVectorFieldStatic(
        Z=static.Z.to(dev, f32), KzzinvL=static.KzzinvL.to(dev, f32),
        Kzzinv=static.Kzzinv.to(dev, f32), sf=static.sf, ell=static.ell)
    pot = gp_rk4.make_fused_gp_potential(s32, data["x0"].to(dev, f32),
                                         data["t"].to(dev, f32),
                                         data["Y"].to(dev, f32))
    gen = torch.Generator(device=dev).manual_seed(n)
    U = (p0["U"].to(dev, f32)[None] + 0.005 * torch.randn(
        (n, 36, 2), generator=gen, device=dev)).requires_grad_(True)
    logsn = (p0["logsn"].to(dev, f32)[None] + 0.005 * torch.randn(
        (n, 2), generator=gen, device=dev)).requires_grad_(True)
    gU, gl = torch.autograd.grad(pot({"U": U, "logsn": logsn}).sum(),
                                 [U, logsn])
    X = torch.cat([U.detach().reshape(n, -1), logsn.detach()], dim=1)
    return X, -torch.cat([gU.reshape(n, -1), gl], dim=1)


@pytest.mark.parametrize("n", [1024, 4096])
def test_svgd_phi_kernel_on_the_svgd_ensemble(gp, n):
    """The clustered ensemble, where the plain float32 matmul form is
    percent-level off float64 (the norm expansion cancels): K8 centres each
    row tile on one of its particles, within 1e-4 of float64 and within 2x
    the plain version's error (floor 1e-5), the JAX gate for float32
    paths."""
    X, S = _svgd_ensemble(gp["dev"], n)
    gamma = stein.rbf_bandwidth(X, None, 256)
    got = svgd_phi(X, S, gamma)
    plain = svgd_phi_reference(X, S, gamma)
    truth = svgd_phi_reference(X.double(), S.double(), gamma.double())
    torch.cuda.synchronize()
    scale = float(truth.abs().max())
    err = float((got.double() - truth).abs().max()) / scale
    err_plain = float((plain.double() - truth).abs().max()) / scale
    assert err <= 1e-4, (err, err_plain)
    assert err <= 2.0 * max(err_plain, 1e-5), (err, err_plain)


@pytest.mark.parametrize("n,d", [(1024, 74), (4096, 74), (130, 200)])
def test_svgd_phi_kernel_is_deterministic(gp, n, d):
    """The column splits' partial sums are added in a fixed order, with no
    atomics: two calls on the same inputs give the same bits."""
    dev = gp["dev"]
    gen = torch.Generator(device=dev).manual_seed(n)
    X = torch.randn((n, d), generator=gen, device=dev)
    S = torch.randn((n, d), generator=gen, device=dev)
    gamma = torch.tensor(0.7 / d, device=dev)
    first = svgd_phi(X, S, gamma)
    second = svgd_phi(X, S, gamma)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("grid", [7, 8])
def test_per_step_solver_at_wide_grids(gp, grid):
    """K9 (one trajectory point a thread, its A and Z in dynamic shared
    memory) at M = 49 and 64 against K1: the same steps on every chain."""
    A, Z, x0, _ = _gp_point_case(gp, 256, 5, 4, grid)
    static = _gp_grid(gp, grid)[0]
    ys1, st1 = gp_dopri5_solve_whole(A, x0, gp["ts"], static)
    ys9, st9 = gp_dopri5_solve(A, x0, gp["ts"], static)
    torch.cuda.synchronize()
    assert Z.shape == (grid * grid, 2)
    assert st9["reached_final_time"]
    for k in ("nfe", "n_accepted", "n_rejected"):
        assert torch.equal(st9[k], st1[k]), k
    assert float((ys9 - ys1).abs().max()) <= 5e-6


@pytest.mark.parametrize("points,grid", [(40, 6), (100, 4), (5, 15),
                                         (2, 32)])
def test_per_step_solver_past_a_warp_or_a_block(gp, points, grid):
    """K9 on GPWidePoint (N = 40 and 100; N = 2 at M = 1,024) and on
    GPPoint beside wide sweeps (N = 5 at M = 225) against K1 on the same
    field type: the same steps on every chain (128 of them: the per-step
    solver takes whole tiles of 128, as the JAX package's)."""
    A, Z, x0, _ = _gp_point_case(gp, 128, points, 4, grid)
    static = _gp_grid(gp, grid)[0]
    ys1, st1 = gp_dopri5_solve_whole(A, x0, gp["ts"], static)
    ys9, st9 = gp_dopri5_solve(A, x0, gp["ts"], static)
    torch.cuda.synchronize()
    assert ys9.shape == (12, 128, points, 2)
    assert st9["reached_final_time"]
    for k in ("nfe", "n_accepted", "n_rejected"):
        assert torch.equal(st9[k], st1[k]), k
    assert float((ys9 - ys1).abs().max()) <= 5e-6


def _lockstep_on_the_card(A, x0, ts, static, max_steps, steps_per_call):
    """The JAX package's loop over K9: per output interval, launches of at
    most steps_per_call iterations while a chain is short of ts[k] and no
    chain has used the budget (a launch after it is spent takes none and
    writes the interval's dense output; the last launch's stands)."""
    from bayesian_ode_tpu_torch.ops import gp_dopri5 as tg

    field = gp_field(float(static.sf), float(static.ell))
    w, x0, ts = ff._prepare(gp_weights(A, static), x0, ts)
    state = tg._step_init(w, x0, ts, static, 1e-7, 1e-9)
    lib = _build.load_library("gp_dopri5_step", (x0.shape[0], A.shape[1]))
    flags = torch.empty(2, dtype=torch.int32, device=A.device)
    ys = torch.empty((ts.shape[0],) + tuple(state.y.shape), device=A.device)
    ys[0] = state.y
    taken = 0
    for k in range(1, ts.shape[0]):
        while True:
            cap = steps_per_call if taken < max_steps else 0
            state, short, taken = tg._interval_launch(
                state, ys, ts, k, cap, lib, w, field.scalars, flags, 1e-7,
                1e-9, 0.9, 10.0, 0.2)
            if not (short and taken < max_steps):
                break
    return ys, state


def test_per_step_solver_takes_the_whole_solves_steps(gp):
    """K9, one launch per output interval: T - 1 launches at the default
    budget, K1's counters on every chain and its trajectories within 5e-6.
    With a budget that binds (max_steps=12, checked every steps_per_call
    iterations), the capped launches equal the JAX package's loop of
    launches of steps_per_call iterations on the card bit for bit, and the
    plain version's mean NFE within 1%."""
    s = gp["static"]
    gen = torch.Generator(device=gp["dev"]).manual_seed(4)
    U = gp["U"][:1] + 3e-3 * torch.randn((256, 36, 2), generator=gen,
                                         device=gp["dev"])
    A = torch.einsum("mk,ckd->cmd", s.KzzinvL, U).contiguous()
    ys1, st1 = gp_dopri5_solve_whole(A, gp["x0"], gp["ts"], s)
    _build.reset_launch_counts()
    ys9, st9 = gp_dopri5_solve(A, gp["x0"], gp["ts"], s)
    torch.cuda.synchronize()
    launched = {k: v for k, v in _build.launch_counts.items() if v}
    assert launched == {"gp_dopri5_step": gp["ts"].shape[0] - 1}, launched
    assert st9["reached_final_time"]
    for k in ("nfe", "n_accepted", "n_rejected"):
        assert torch.equal(st9[k], st1[k]), k
    assert float((ys9 - ys1).abs().max()) <= 5e-6
    ys3, st3 = gp_dopri5_solve(A, gp["x0"], gp["ts"], s, steps_per_call=3)
    assert torch.equal(ys3, ys9) and torch.equal(st3["nfe"], st9["nfe"])
    for steps in (1, 3):
        ysb, stb = gp_dopri5_solve(A, gp["x0"], gp["ts"], s, max_steps=12,
                                   steps_per_call=steps)
        ysr, ref = _lockstep_on_the_card(A, gp["x0"], gp["ts"], s, 12,
                                         steps)
        _, stp = gp_dopri5_solve_plain(A.cpu(), gp["x0"].cpu(),
                                       gp["ts"].cpu(), _static_cpu(s),
                                       max_steps=12, steps_per_call=steps)
        taken = stb["n_accepted"] + stb["n_rejected"]
        assert not stb["reached_final_time"]
        assert 12 <= int(taken.max()) < 12 + steps
        assert torch.equal(ysb, ysr)
        assert torch.equal(stb["nfe"], ref.nfe)
        assert torch.equal(stb["n_accepted"], ref.nacc)
        mk, mp = float(stb["nfe"].float().mean()), float(
            stp["nfe"].float().mean())
        assert abs(mk - mp) <= 0.01 * mp, (mk, mp)


def test_per_step_solver_at_every_budget(gp):
    """K9's solve (every interval launched once with its cap read on the
    card, and launch by launch where that left a chain short with budget
    left) against the JAX package's loop on the card, bit for bit, at
    every budget of 1 to 40 steps with steps_per_call 1 and 3, on 256
    chains of different speeds (A scaled by 0.5 to 3), so that the budget
    binds on some chains while others have finished their interval; some
    of these solves run launch by launch and some do not."""
    s = gp["static"]
    gen = torch.Generator(device=gp["dev"]).manual_seed(6)
    U = gp["U"][:1] + 3e-3 * torch.randn((256, 36, 2), generator=gen,
                                         device=gp["dev"])
    scale = torch.linspace(0.5, 3.0, 256, device=gp["dev"])[
        torch.randperm(256, generator=gen, device=gp["dev"])]
    A = (scale[:, None, None] * torch.einsum("mk,ckd->cmd", s.KzzinvL,
                                             U)).contiguous()
    T = gp["ts"].shape[0]
    launches = set()
    for max_steps in range(1, 41):
        for steps in (1, 3):
            _build.reset_launch_counts()
            ys, st = gp_dopri5_solve(A, gp["x0"], gp["ts"], s,
                                     max_steps=max_steps,
                                     steps_per_call=steps)
            launches.add(_build.launch_counts["gp_dopri5_step"])
            ysr, ref = _lockstep_on_the_card(A, gp["x0"], gp["ts"], s,
                                             max_steps, steps)
            assert torch.equal(ys, ysr), (max_steps, steps)
            assert torch.equal(st["nfe"], ref.nfe), (max_steps, steps)
            assert torch.equal(st["n_accepted"], ref.nacc)
    assert T - 1 in launches and max(launches) > T - 1, launches


def _static_cpu(s):
    return kr.GPVectorFieldStatic(Z=s.Z.cpu(), KzzinvL=s.KzzinvL.cpu(),
                                  Kzzinv=s.Kzzinv.cpu(), sf=s.sf, ell=s.ell)
