"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: every test skips where torch sees no CUDA device.  On a
machine with an H100 and nvcc they run with

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda_kernels.py

(`--noconftest` because the suite's conftest imports JAX, which that
machine need not have; this file imports torch and the port only).

Small shapes and the cases `chip_smoke.py` does not reach at full size:
a chain count that is not a multiple of the 64-thread block, the PI
controller, budget exhaustion and record overflow.  Gates as the smoke's:
trajectories within 1e-4 * max|y| of the plain version (two float32 solves
whose step meshes differ by rounding in the floor-bound regime), mean NFE
within 1%, gradients within 1e-3 max-rel (the JAX package's float32 gate).
"""
import pytest
import torch

from bayesian_ode_tpu_torch.models import kernel_regression as kr
from bayesian_ode_tpu_torch.models import make_dataset
from bayesian_ode_tpu_torch.ops import _build
from bayesian_ode_tpu_torch.ops import fused_adaptive as fa
from bayesian_ode_tpu_torch.ops.gp_dopri5 import (
    _pack_initial,
    gp_dopri5_solve_whole,
    gp_dopri5_solve_whole_plain,
)
from bayesian_ode_tpu_torch.ops.gp_dopri5_grad import (
    gp_dopri5_trajectory,
    gp_dopri5_trajectory_plain,
    make_fused_gp_potential_dopri5,
)

pytestmark = pytest.mark.cuda

C = 200                      # 3 full blocks of 64 and a ragged one


@pytest.fixture(scope="module")
def gp():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels build with nvcc for "
                    "sm_90a and run only there")
    dev = torch.device("cuda", 0)
    kr.full_f32_matmul()
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
            "static": s32, "dev": dev}


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
    args = (gp["A"], Z, x0b, f0, dt0, gp["ts"], s.sf, s.ell, 1e-7, 1e-9,
            0.9, 10.0, 0.2, 100_000, "i")
    _, _, nacc, _, _, rec = fa.fwd(*args, record=True, store_steps=128)
    _, _, nacc_p, _, _, rec_p = fa.fwd_plain(*args, store_steps=128)
    g = torch.randn((12, C, 5, 2),
                    generator=torch.Generator(device=gp["dev"]).manual_seed(5),
                    device=gp["dev"])
    Abar_k, lbar_k = fa.bwd(gp["A"], Z, gp["ts"], rec, nacc, g, s.sf, s.ell)
    Abar_p, lbar_p = fa.bwd_plain(gp["A"], Z, gp["ts"], rec_p, nacc_p, g,
                                  s.sf, s.ell)
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
