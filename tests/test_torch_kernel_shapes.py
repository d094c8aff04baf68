"""The shapes the port's CUDA kernels take, checked before any build, and
the plain versions against the JAX package at the widened shapes.

`ops/_build.py::check_shape` refuses what the kernels cannot compile with
a NotImplementedError naming ROADMAP queue 1 item 19 and the limit: more
than 128 trajectory points for the GP field (one point a thread, a chain
over up to 4 warps), more than 1,024 inducing points, more than 32 for
the MLP field (one state component a lane to 16, one point a lane past
it), more than 64 for the spiral field (up to 4 state components a lane),
an MLP wider than 128 at N <= 16 or 64 at N <= 32 (four or two hidden
units a lane), a spiral wider than 256, and a block's shared memory past
48 KB of static or 232,448 B of dynamic memory, by the arithmetic of the
kernels' structs (`smem_bytes`; the card tests hold it to the built
libraries' reports).  No card or nvcc is
needed: the check runs first, so here `load_library` raises it where it
would otherwise fail to find nvcc.

Parity gates are those of the existing parity tests: the spiral engine at
JAX's N = 9 case (tests/test_fused_field.py: H = 6, C = 4, T = 6,
rtol 1e-5) as test_torch_spiral_dopri5.py holds it (trajectories within
1e-4 * max|y| and step counts by `check_solve`, the replay gradient
within 1e-3 of jax.grad through the JAX engine), and the GP rk4 kernels'
plain versions at a 7 x 7 inducing grid as test_torch_gp_rk4.py holds
them at 6 x 6 (trajectories within 1e-5 * max|y|, cotangents within 1e-5
max-rel of the JAX kernels' jax.vjp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ops import spiral_dopri5 as js
from bayesian_ode_tpu.ops.gp_rk4 import gp_rk4_trajectory as jtrajectory
from bayesian_ode_tpu_torch.models import spiral
from bayesian_ode_tpu_torch.ops import _build
from bayesian_ode_tpu_torch.ops import gp_rk4 as tg
from bayesian_ode_tpu_torch.ops import spiral_dopri5 as ts_
from torch_parity import (
    check_solve,
    gp_problem,
    max_rel,
    spiral_params,
    to_np,
    tree_max_rel,
)

ITEM = "ROADMAP queue 1 item 19"

# (family, shape) past one limit each: GP N = 129 (a chain over at most 4
# warps) and M = 1,025 (past a 32 x 32 grid), each GP family; MLP N = 33;
# spiral N = 65 (at most 4 components a lane); MLP H = 129 at N = 5 and
# H = 65 at N = 17; a spiral whose one-warp block passes 232,448 B of
# dynamic memory (N = 64, H = 128: its 7 stage slots' tanh values
# 229,376 B, 233,472 B in all)
PAST = [
    ("gp_dopri5", (129, 36), "N <= 128"),
    ("gp_rk4", (129, 36), "N <= 128"),
    ("gp_dopri5_step", (129, 36), "N <= 128"),
    ("mlp_dopri5", (33, 32), "N <= 32"),
    ("mlp_rk4", (33, 32), "N <= 32"),
    ("spiral_dopri5", (65, 6), "N <= 64"),
    ("mlp_dopri5", (5, 129), "H <= 128"),
    ("mlp_rk4", (17, 65), "H <= 64"),
    ("gp_dopri5", (5, 1025), "M <= 1024"),
    ("gp_rk4", (5, 1025), "M <= 1024"),
    ("gp_dopri5_step", (5, 1025), "M <= 1024"),
    ("spiral_dopri5", (64, 128), "232448 B"),
]

# the shapes of the card tests and chip_smoke.py
TAKEN = [
    ("gp_dopri5", (5, 36)), ("gp_dopri5", (3, 36)), ("gp_dopri5", (5, 49)),
    ("gp_dopri5", (5, 64)), ("gp_dopri5", (32, 196)),
    ("gp_rk4", (5, 36)), ("gp_rk4", (3, 36)), ("gp_rk4", (5, 49)),
    ("gp_rk4", (5, 64)),
    ("gp_dopri5_step", (5, 36)), ("gp_dopri5_step", (5, 49)),
    ("gp_dopri5_step", (5, 64)),
    ("mlp_rk4", (5, 20)), ("mlp_rk4", (5, 32)), ("mlp_rk4", (9, 32)),
    ("mlp_rk4", (16, 32)),
    ("mlp_dopri5", (5, 20)), ("mlp_dopri5", (5, 32)),
    ("mlp_dopri5", (9, 32)), ("mlp_dopri5", (16, 32)),
    *((family, shape) for family in ("mlp_rk4", "mlp_dopri5")
      for shape in ((5, 66), (5, 128), (32, 64), (17, 4), (2, 66),
                    (16, 128), (32, 33))),
    ("spiral_dopri5", (5, 50)), ("spiral_dopri5", (5, 20)),
    ("spiral_dopri5", (9, 6)), ("spiral_dopri5", (16, 50)),
    ("fhn_dopri5", (5,)), ("fhn_dopri5", (32,)), ("fhn_dopri5", (40,)),
    ("svgd_phi", ()),
    # past one warp or a block's shared memory (csrc/gp_wide_field.cuh,
    # csrc/spiral_wide_field.cuh): the shapes refused before, the card's
    # and chip_smoke.py's, and the ceilings
    *((family, shape) for family in ("gp_dopri5", "gp_rk4", "gp_dopri5_step")
      for shape in ((33, 36), (5, 225), (40, 36), (100, 16), (2, 1024),
                    (64, 36), (5, 400), (5, 1024), (128, 1024), (1, 1024),
                    (32, 1024))),
    *(("spiral_dopri5", shape) for shape in (
        (17, 6), (16, 128), (20, 40), (32, 50), (32, 128), (64, 64),
        (32, 256), (64, 1))),
]


@pytest.mark.parametrize("family,shape,limit", PAST)
def test_check_shape_names_item_19_and_the_limit(family, shape, limit):
    with pytest.raises(NotImplementedError, match=ITEM) as err:
        _build.check_shape(family, shape)
    assert limit in str(err.value)


@pytest.mark.parametrize("family,shape", TAKEN)
def test_check_shape_takes_the_tested_shapes(family, shape):
    _build.check_shape(family, shape)


@pytest.mark.parametrize("family,shape,limit", PAST)
def test_load_library_raises_before_any_build(family, shape, limit):
    """No nvcc here: without the check first, load_library and build
    would raise RuntimeError("nvcc not found ...")."""
    with pytest.raises(NotImplementedError, match=ITEM):
        _build.load_library(family, shape)
    with pytest.raises(NotImplementedError, match=ITEM):
        _build.build([("fhn_dopri5", (5,)), (family, shape)])
    assert (family, shape) not in _build._LIBS


# What ptxas reported as each kernel's static shared memory on the H100 at
# the main shape (N = 5, M = 36, MLP H = 32, spiral H = 50; PERF.md §6),
# where the buffers were static: the arithmetic of the same structs.  The
# GP rk4 forward (K4) and the per-step solver (K9) now keep GPPoint's
# buffers, the solves' 7,200 B (K9's one chain a thread kept 18,720 B),
# and the spiral's forward its 4 warps' gathered points (48 B each; it
# had none while it kept the state on every lane).
MAIN = [
    ("gp_dopri5", (5, 36), {"fwd": 7200, "bwd": 35872}),
    ("gp_rk4", (5, 36), {"fwd": 7200, "bwd": 31776}),
    ("gp_dopri5_step", (5, 36), {"step": 7200}),
    ("mlp_rk4", (5, 32), {"fwd": 2752, "bwd": 39872}),
    ("mlp_dopri5", (5, 32), {"fwd": 2752, "bwd": 27904}),
    ("spiral_dopri5", (5, 50), {"fwd": 192, "bwd": 37376}),
    ("fhn_dopri5", (5,), {"fwd": 0, "bwd": 0}),
    ("svgd_phi", (), {"phi": 43392, "combine": 0}),
]


@pytest.mark.parametrize("family,shape,want", MAIN)
def test_smem_arithmetic_at_the_main_shape(family, shape, want):
    assert _build.smem_bytes(family, shape) == want


def test_widened_blocks_fit_by_fewer_warps_or_dynamic_memory():
    """K3 GP at a 7 x 7 grid takes 200 * 49 + 1,024 * (49 - 8) B, past the
    48 KB a static block may have; the MLP's K7 and K3 and the spiral's
    buffers at N = 16 fit 48 KB with fewer warps a block."""
    assert _build.smem_bytes("gp_dopri5", (5, 49))["bwd"] == 51784
    assert _build.smem_bytes("mlp_rk4", (16, 32))["bwd"] == 2 * 21632
    assert _build.smem_bytes("mlp_dopri5", (16, 32))["bwd"] == 34304
    assert _build.smem_bytes("spiral_dopri5", (9, 50))["bwd"] == 2 * 16768
    assert _build.smem_bytes("spiral_dopri5", (16, 50))["bwd"] == 29696


# The MLP field past one warp (csrc/mlp_wide_field.cuh), one warp and
# chain a block, every buffer dynamic: W2's rows of ceil(H/32) * 32 + 4
# floats over H rounded to 4 rows, the h1 copy (N rows of ceil(H/32) * 32)
# and the gathered point in the forwards; the sweeps' stage slots (K7 4,
# MLP K3 7) each hold a2 and a point, then a cotangent, and W2bar after
# them.  (5, 128): 4 units a lane; (32, 64): 2 units and one point a lane,
# K3's slots 7 x 32 x 64 floats (57,344 B); (16, 128), the largest block,
# 199,680 B of the 232,448.
@pytest.mark.parametrize("family,shape,want", [
    ("mlp_rk4", (5, 128), {"fwd": 70192, "bwd": 146160}),
    ("mlp_dopri5", (5, 128), {"fwd": 70192, "bwd": 153984}),
    ("mlp_rk4", (32, 64), {"fwd": 25856, "bwd": 76032}),
    ("mlp_dopri5", (32, 64), {"fwd": 25856, "bwd": 101376}),
    ("mlp_dopri5", (16, 128), {"fwd": 75904, "bwd": 199680}),
])
def test_wide_mlp_blocks_are_dynamic(family, shape, want):
    assert _build.smem_bytes(family, shape) == want
    assert _build.dynamic_smem(family, shape)
    _build.check_shape(family, shape)


# The GP kernels past one warp or a block's shared memory
# (csrc/gp_wide_field.cuh, GPWidePoint): A and Z 8 B an inducing point a
# chain and a grid, the sweeps' Abar one column a chain (8 B a point) in
# place of GPPoint's column a thread, 8 B a trajectory point for the error
# norm past N = 32 (and one float2 to N = 32).  At N = 5, M = 225 and 1,024
# the forwards keep GPPoint (24 chains a block); K3 and K5 take 24 chains
# a block at M = 225 and 12 at M = 1,024 (two warps), N = 1 at M = 1,024
# 13 chains a one-warp block; past N = 32 a block is a chain.  The spiral
# past N = 16 or 48 KB (csrc/spiral_wide_field.cuh): one warp a block, the
# forward's point and the sweep's SpiralBuf<7>, dynamic.
@pytest.mark.parametrize("family,shape,want", [
    ("gp_dopri5", (5, 225), {"fwd": 45000, "bwd": 88208}),
    ("gp_rk4", (5, 225), {"fwd": 45000, "bwd": 88208}),
    ("gp_dopri5", (5, 1024), {"fwd": 204800, "bwd": 204808}),
    ("gp_rk4", (5, 1024), {"fwd": 204800, "bwd": 204808}),
    ("gp_dopri5_step", (5, 1024), {"step": 204800}),
    ("gp_dopri5_step", (1, 1024), {"step": 114696}),
    ("gp_rk4", (1, 1024), {"fwd": 114696, "bwd": 221192}),
    ("gp_dopri5", (128, 1024), {"fwd": 17408, "bwd": 50176}),
    ("gp_dopri5", (64, 36), {"fwd": 1088, "bwd": 1664}),
    ("spiral_dopri5", (16, 128), {"fwd": 128, "bwd": 58368}),
    ("spiral_dopri5", (32, 50), {"fwd": 256, "bwd": 59392}),
    ("spiral_dopri5", (32, 128), {"fwd": 256, "bwd": 116736}),
    ("spiral_dopri5", (64, 64), {"fwd": 512, "bwd": 118784}),
    ("spiral_dopri5", (32, 256), {"fwd": 256, "bwd": 231424}),
])
def test_wide_gp_and_spiral_blocks_are_dynamic(family, shape, want):
    got = _build.smem_bytes(family, shape)
    assert got == want
    assert _build.dynamic_smem(family, shape)
    assert max(got.values()) <= _build.DYNAMIC_SMEM_MAX
    _build.check_shape(family, shape)


def test_every_gp_shape_to_the_ceilings_fits_a_block():
    """Every N <= 128 and M <= 1,024 together: each GP kernel's block fits
    232,448 B, on GPPoint where its block fits and on GPWidePoint past
    that or past N = 32 (gp_field.cuh's gp_narrow)."""
    for N in range(1, 129):
        for M in range(1, 1025):
            for R, acc in ((8, False), (8, True), (12, True)):
                block = _build.gp_block((N, M), R, acc)
                assert block.smem <= _build.DYNAMIC_SMEM_MAX, (N, M, R)
                assert block.wide or N <= 32, (N, M, R)
    assert not _build.gp_block((32, 196), 8, True).wide
    assert _build.gp_block((5, 225), 8, True).wide


@pytest.mark.parametrize("family", ["mlp_rk4", "mlp_dopri5"])
def test_narrow_mlp_blocks_stay_static(family):
    """H <= 32 and N <= 16 keep mlp_field.cuh's static buffers, limits
    and arithmetic."""
    for shape in ((5, 32), (16, 32), (1, 1)):
        assert not _build.dynamic_smem(family, shape)
    assert _build.mlp_max_hidden(16) == 128
    assert _build.mlp_max_hidden(17) == 64


# The spread forwards' blocks past the main shape: the spiral's 4 warps
# each gather the 2N floats of the point, padded to 4 (SpiralFwdBuf, 16 B
# aligned); the FitzHugh-Nagumo forward keeps theta in registers and
# gathers its norm by shuffles, one point a thread to N = 32 and one chain
# a thread past it.
@pytest.mark.parametrize("family,shape,fwd", [
    ("spiral_dopri5", (9, 6), 4 * 80), ("spiral_dopri5", (16, 50), 4 * 128),
    ("spiral_dopri5", (1, 50), 4 * 16), ("fhn_dopri5", (32,), 0),
    ("fhn_dopri5", (40,), 0),
])
def test_spread_forward_buffers(family, shape, fwd):
    assert _build.smem_bytes(family, shape)["fwd"] == fwd
    _build.check_shape(family, shape)


# ---- the plain versions against JAX at the widened shapes ----

SPIRAL_TOL = {"rtol": 1e-5, "atol": 1e-7}
N9, T6, C4 = 9, 6, 4


@pytest.fixture(scope="module")
def spiral9():
    """JAX's N = 9 spiral case: its engine's solve and replay gradient."""
    params = spiral_params(C=C4, H=6, seed=9)
    x0 = np.stack([np.linspace(-1.5, 2.0, N9),
                   np.linspace(0.8, -0.9, N9)], axis=-1).astype(np.float32)
    ts = np.linspace(0.0, 1.2, T6).astype(np.float32)
    W = np.random.RandomState(5).randn(T6, C4, N9, 2).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ys, st = js.spiral_dopri5_solve_stats(jp, jnp.asarray(x0),
                                          jnp.asarray(ts), interpret=True,
                                          **SPIRAL_TOL)
    grad = jax.grad(lambda p: jnp.sum(js.spiral_dopri5_trajectory(
        p, jnp.asarray(x0), jnp.asarray(ts), interpret=True,
        **SPIRAL_TOL) * W))(jp)
    return {"params": params, "x0": x0, "ts": ts, "W": W, "ys": ys,
            "st": st, "grad": grad}


def _spiral9_params(ref):
    return {k: v.requires_grad_(True) for k, v in
            spiral.params_from_numpy(ref["params"]).items()}


def test_spiral_plain_forward_at_nine_points_matches_jax(spiral9):
    ys, st = ts_.spiral_dopri5_solve_stats(
        _spiral9_params(spiral9), torch.tensor(spiral9["x0"]),
        torch.tensor(spiral9["ts"]), **SPIRAL_TOL)
    assert tuple(ys.shape) == (T6, C4, N9, 2)
    check_solve(ys, st, spiral9["ys"], spiral9["st"])


def test_spiral_plain_gradient_at_nine_points_matches_jax(spiral9):
    params = _spiral9_params(spiral9)
    ys = ts_.spiral_dopri5_trajectory(params, torch.tensor(spiral9["x0"]),
                                      torch.tensor(spiral9["ts"]),
                                      **SPIRAL_TOL)
    (ys * torch.tensor(spiral9["W"])).sum().backward()
    assert tree_max_rel({k: v.grad for k, v in params.items()},
                        spiral9["grad"]) <= 1e-3


@pytest.fixture(scope="module")
def gp49():
    """The GP rk4 problem on a 7 x 7 inducing grid: the JAX kernels'
    trajectories and their vjp for a seeded cotangent."""
    p = gp_problem(C=128, M=7)
    ts = jnp.asarray(p["t"])

    def traj(A, x0):
        return jtrajectory(A, x0, ts, p["jstatic32"], tile=128,
                           interpret=True)

    ys, vjp = jax.vjp(traj, jnp.asarray(p["A"]), jnp.asarray(p["x0"]))
    g = np.random.RandomState(5).randn(*ys.shape).astype(np.float32)
    Abar, x0bar = vjp(jnp.asarray(g))
    return p, np.asarray(ys), g, np.asarray(Abar), np.asarray(x0bar)


def _gp49_tensors(p):
    s = p["tstatic"]
    return (torch.tensor(p["A"]), s.Z.to(torch.float32),
            torch.tensor(p["x0"]),
            torch.diff(torch.tensor(p["t"], dtype=torch.float32)),
            s.sf, s.ell)


def test_gp_rk4_plain_forward_at_a_7x7_grid_matches_jax(gp49):
    p, ys_j, *_ = gp49
    A, Z, x0, dts, sf, ell = _gp49_tensors(p)
    assert A.shape == (128, 49, 2)
    ys = tg.gp_rk4_fwd_plain(A, Z, x0, dts, sf, ell)
    assert tuple(ys.shape) == ys_j.shape
    assert np.max(np.abs(to_np(ys) - ys_j)) <= 1e-5 * np.max(np.abs(ys_j))


def test_gp_rk4_plain_backward_at_a_7x7_grid_matches_jax(gp49):
    p, _, g, Abar_j, x0bar_j = gp49
    A, Z, x0, dts, sf, ell = _gp49_tensors(p)
    ys = tg.gp_rk4_fwd_plain(A, Z, x0, dts, sf, ell)
    Abar, lbar = tg.gp_rk4_bwd_plain(A, Z, ys, torch.tensor(g), dts, sf, ell)
    assert Abar.shape == (128, 49, 2)
    assert max_rel(Abar, Abar_j) <= 1e-5
    assert max_rel(lbar.sum(dim=0), x0bar_j) <= 1e-5
