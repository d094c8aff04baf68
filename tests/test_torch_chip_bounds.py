"""The bounds `chip_smoke.py` reports beside each kernel's time, counted by
hand at the main paths' shapes (10,112 chains, N=5 trajectories, T=60
output times; GP M=36, MLP H=32, spiral H=50), and its occupancy count.

A reverse sweep's least work is each stage point's field evaluation once
plus each VJP's own part (what the VJP adds to a forward whose activations
it is given): an rk4 step has 4 stage points and 4 VJPs, an accepted
adaptive step 7 and 7.  The hand counts below are read off
`csrc/*_field.cuh`, an FMA as 2 flops.  No card needed: `chip_smoke` is
imported without running `main`.
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

C, N, T = 10112, 5, 60
STEPS = C * (T - 1)

# (field, width): ((forward flops, expf/tanhf), (VJP own flops, calls))
HAND = {
    # per m: distance 5, exponent and sf^2 2, the two sums 4; VJP per m:
    # Abar 4, a . cot 3, weight 2, ybar 4
    ("gp", 36): ((36 * 11, 36), (36 * 13, 0)),
    # 32 units x (a1 4 + ELUs 2 + a2 65 + out 4) + b3 2; VJP: 2 x 32^2 x 2
    # products + 32 x 20 + 2
    ("mlp", 32): ((32 * 75 + 2, 64), (4096 + 640 + 2, 0)),
    # cubes 4 + 50 units x 8; VJP 50 x 19 + 8
    ("spiral", 50): ((404, 50), (958, 0)),
    ("fhn", None): ((11, 0), (22, 0)),
}


@pytest.mark.parametrize("field,width", list(HAND))
def test_field_cost_is_the_hand_count(field, width):
    assert chip_smoke.field_cost(field, width) == HAND[(field, width)]


@pytest.fixture
def counts(monkeypatch):
    """bound() returning its (bytes, flops, special-function calls)."""
    monkeypatch.setattr(chip_smoke, "bound", lambda b, f, s: (b, f, s))


@pytest.mark.parametrize("field,width", [("gp", 36), ("mlp", 32)])
def test_rk4_reverse_sweep_counts_each_stage_forward_once(counts, field,
                                                          width):
    (f, s), (fv, sv) = HAND[(field, width)]
    w_bytes = 1000
    _, (nbytes, flops, sfu) = chip_smoke.rk4_bounds(field, width, C, N, T,
                                                    w_bytes, w_bytes)
    assert flops == STEPS * N * (4 * f + 4 * fv)
    assert sfu == STEPS * N * 4 * s
    # below a count that evaluates each VJP's own forward again (7
    # forwards a step where 4 are needed)
    assert flops < STEPS * N * (7 * f + 4 * fv)
    assert nbytes == 2 * w_bytes + 2 * T * C * 2 * N * 4 + C * 2 * N * 4


@pytest.mark.parametrize("field,width", list(HAND))
def test_replay_backward_counts_each_stage_forward_once(counts, field,
                                                        width):
    (f, s), (fv, sv) = HAND[(field, width)]
    attempts, accepted = 41 * C, 37 * C
    _, (_, flops, sfu) = chip_smoke.adaptive_bounds(
        field, width, C, N, T, 1000, 1000, attempts, accepted)
    NS = 2 * N
    assert flops == accepted * (7 * N * (f + fv) + 2 * 70 * NS)
    assert sfu == accepted * 7 * N * s
    assert flops < accepted * (7 * N * (2 * f + fv) + 2 * 70 * NS)


def test_gp_recompute_floor_takes_two_expf_a_point_and_stage(counts):
    """The floor of a GP backward that recomputes its kernel values in each
    VJP (K3 GP, K5): per point and stage point, 2M expf and the VJP's own
    part plus 7 flops an inducing point, beside the bound's M expf."""
    (f, s), (fv, _) = HAND[("gp", 36)]
    vjp = chip_smoke.gp_recompute_vjp(36)
    assert vjp == (fv + 7 * 36, 36)
    _, (_, flops, sfu) = chip_smoke.rk4_bounds("gp", 36, C, N, T, 1000, 1000,
                                               vjp=vjp)
    assert sfu == STEPS * N * 4 * 2 * 36
    assert flops == STEPS * N * 4 * (f + fv + 7 * 36)
    attempts, accepted = 41 * C, 37 * C
    _, (_, flops, sfu) = chip_smoke.adaptive_bounds(
        "gp", 36, C, N, T, 1000, 1000, attempts, accepted, vjp=vjp)
    assert sfu == accepted * 7 * N * 2 * 36
    assert flops == accepted * (7 * N * (f + fv + 7 * 36) + 2 * 70 * 2 * N)


def test_the_mlp_reverse_sweep_bound_at_the_main_shape():
    """K7's bound at the driver's shape: 10,112 x 59 x 5 x 4 x 7,140 flops
    at 67 TFLOP/s, operation-bound."""
    w = C * (2 * 32 + 32 + 32 * 32 + 32 + 32 * 2 + 2) * 4
    _, (ms, by) = chip_smoke.rk4_bounds("mlp", 32, C, N, T, w, w)
    assert by == "operations"
    assert ms == pytest.approx(STEPS * N * 4 * 7140 / 67e12 * 1e3)


@pytest.mark.parametrize("regs,smem,threads,warps", [
    (255, 16896, 128, 8),      # 2 blocks by registers
    (168, 21216, 128, 12),     # 3 blocks by registers
    (128, 39872, 128, 16),     # K7: 4 blocks by registers
    (128, 29184, 64, 14),      # 7 blocks by shared memory
    (128, 27904, 64, 16),      # MLP K3: 8 blocks by registers
    (32, 0, 256, 64),          # the 64-warp limit
])
def test_warps_per_sm(regs, smem, threads, warps):
    assert chip_smoke.warps_per_sm(regs, smem, threads) == warps


@pytest.mark.parametrize("regs,smem,threads,chains,warps,blocks_an_sm", [
    (220, 37152, 64, 64, 8, 4),     # K3 GP, one chain a thread: 158 blocks
    (117, 37152, 64, 64, 12, 6),    # K5, one chain a thread
    (128, 35872, 128, 24, 16, 4),   # K3 GP, one thread a point: 422 blocks
    (85, 44064, 128, 24, 20, 5),    # its Abar all in shared memory
    (168, 7200, 128, 24, 12, 3),    # 3 blocks an SM: 1.07 waves
    (128, 18720, 64, 64, 16, 8),    # GP K1/K2, one chain a thread: 158
    (76, 7200, 128, 24, 24, 6),     # GP K1/K2, one thread a point: 422
    (80, 37376, 128, 4, 24, 6),     # spiral K3, one component a lane
    (80, 23936, 128, 4, 24, 6),     # K6, the state on every lane
    (96, 2752, 128, 4, 20, 5),      # K6, one component a lane: 632 blocks
    (128, 27904, 64, 2, 16, 8),     # MLP K2 DOPRI5, the state on every lane
    (167, 27904, 64, 2, 12, 6),     # MLP K2 TSIT5, the same
    (123, 2752, 128, 4, 16, 4),     # MLP K2, one component a lane
    (80, 18720, 64, 64, 22, 11),    # K4, one chain a thread: 158 blocks
    (56, 7200, 128, 24, 36, 9),     # K4, one thread a point: 422 blocks
    (104, 51784, 128, 24, 16, 4),   # K3 GP at a 7x7 grid, dynamic memory
    (103, 70144, 128, 24, 12, 3),   # K3 GP at an 8x8 grid: 1.07 waves
    (97, 87808, 256, 32, 16, 2),    # K8 before the column splits
    (127, 43392, 128, 32, 16, 4),   # K8, 32 rows a block: 4 by registers
    (128, 0, 128, 4, 16, 4),        # spiral K2, the state on every lane
    (155, 0, 128, 4, 12, 3),        # its TSIT5 instance
    (64, 192, 128, 4, 32, 8),       # spiral K2, one component a lane
    (128, 0, 64, 64, 16, 8),        # FHN K2, one chain a thread
    (59, 0, 128, 24, 32, 8),        # FHN K2, one point a thread
])
def test_occupancy_warps_and_waves(regs, smem, threads, chains, warps,
                                   blocks_an_sm):
    got_warps, waves = chip_smoke.occupancy(regs, smem, threads, chains, C)
    assert got_warps == warps
    assert waves == pytest.approx(-(-C // chains) / (blocks_an_sm * 132))
    if blocks_an_sm == 3 and chains == 24:
        assert waves > 1.06


def test_ptxas_summary_reads_registers_spills_and_shared_memory():
    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN4bode18mlp_rk4_bwd_kernelEPKfS1_' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN4bode18mlp_rk4_bwd\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 0 barriers, 42432 bytes "
        "smem\n")
    assert chip_smoke.ptxas_summary("mlp_rk4", (5, 32), log) == [
        ("mlp_rk4_bwd", 128, 8, 4, 42432)]


def test_ptxas_summary_names_the_per_point_gp_replay():
    """K3 GP (`dopri5_bwd_kernel_bounded` over GPPoint<8>) at DOPRI5: the
    name chip_smoke.OCCUPANCY_BLOCKS keys."""
    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN4bode25dopri5_bwd_kernel_boundedINS_7GPPointILi8EEENS_6Dopri5"
        "EEEvNT_4ArgsENS4_5GradsEPKfS8_PKiS8_iiPf' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 35872 bytes "
        "smem\n")
    name = "dopri5_bwd GPPoint Dopri5"
    assert chip_smoke.ptxas_summary("gp_dopri5", (5, 36), log) == [
        (name, 128, 0, 0, 35872)]
    assert ("gp_dopri5", name) in chip_smoke.OCCUPANCY_BLOCKS


@pytest.mark.parametrize("family,mangled,regs,smem,name", [
    # GP K2 and K1 (dopri5_fwd_kernel_bounded over GPPoint<8>)
    ("gp_dopri5", "_ZN4bode25dopri5_fwd_kernel_boundedINS_7GPPointILi8EEEN"
     "S_6Dopri5ELb1EEEvNT_4ArgsEPKfS7_S7_S7_iiNS_9SolveArgsENS_6FwdOutE",
     76, 7200, "dopri5_fwd GPPoint Dopri5 record"),
    ("gp_dopri5", "_ZN4bode25dopri5_fwd_kernel_boundedINS_7GPPointILi8EEEN"
     "S_5Tsit5ELb0EEEvNT_4ArgsEPKfS7_S7_S7_iiNS_9SolveArgsENS_6FwdOutE",
     78, 7200, "dopri5_fwd GPPoint Tsit5 no-record"),
    # K6 (mlp_rk4_fwd_kernel) and MLP K2 (dopri5_fwd_kernel_bounded over
    # MLPDopri5Fwd)
    ("mlp_rk4", "_ZN4bode18mlp_rk4_fwd_kernelEPKfS1_S1_S1_S1_S1_S1_S1_iiPf",
     96, 2752, "mlp_rk4_fwd"),
    ("mlp_dopri5", "_ZN4bode25dopri5_fwd_kernel_boundedINS_12MLPDopri5FwdEN"
     "S_5Tsit5ELb1EEEvNT_4ArgsEPKfS6_S6_S6_iiNS_9SolveArgsENS_6FwdOutE",
     122, 2752, "dopri5_fwd MLPDopri5Fwd Tsit5 record"),
    # spiral K3 (dopri5_bwd_kernel over SpiralDopri5)
    ("spiral_dopri5", "_ZN4bode17dopri5_bwd_kernelINS_12SpiralDopri5ENS_6D"
     "opri5EEEvNT_4ArgsENS3_5GradsEPKfS7_PKiS7_iiPf", 80, 37376,
     "dopri5_bwd SpiralDopri5 Dopri5"),
    # spiral K2 (dopri5_fwd_kernel_bounded over SpiralDopri5Fwd)
    ("spiral_dopri5", "_ZN4bode25dopri5_fwd_kernel_boundedINS_15SpiralDopri"
     "5FwdENS_6Dopri5ELb1EEEvNT_4ArgsEPKfS6_S6_S6_iiNS_9SolveArgsENS_6FwdO"
     "utE", 64, 192, "dopri5_fwd SpiralDopri5Fwd Dopri5 record"),
    ("spiral_dopri5", "_ZN4bode25dopri5_fwd_kernel_boundedINS_15SpiralDopri"
     "5FwdENS_5Tsit5ELb0EEEvNT_4ArgsEPKfS6_S6_S6_iiNS_9SolveArgsENS_6FwdOut"
     "E", 64, 192, "dopri5_fwd SpiralDopri5Fwd Tsit5 no-record"),
    # FHN K2 (dopri5_fwd_kernel_bounded over FHNPoint<5>)
    ("fhn_dopri5", "_ZN4bode25dopri5_fwd_kernel_boundedINS_8FHNPointILi5EE"
     "EENS_6Dopri5ELb1EEEvNT_4ArgsEPKfS7_S7_S7_iiNS_9SolveArgsENS_6FwdOutE",
     59, 0, "dopri5_fwd FHNPoint Dopri5 record"),
    ("fhn_dopri5", "_ZN4bode25dopri5_fwd_kernel_boundedINS_8FHNPointILi5EE"
     "EENS_5Tsit5ELb0EEEvNT_4ArgsEPKfS7_S7_S7_iiNS_9SolveArgsENS_6FwdOutE",
     56, 0, "dopri5_fwd FHNPoint Tsit5 no-record"),
    # FHN K3 (dopri5_bwd_kernel_bounded over FHNPoint<5>)
    ("fhn_dopri5", "_ZN4bode25dopri5_bwd_kernel_boundedINS_8FHNPointILi5EE"
     "EENS_6Dopri5EEEvNT_4ArgsENS4_5GradsEPKfS8_PKiS8_iiPf", 80, 0,
     "dopri5_bwd FHNPoint Dopri5"),
    ("fhn_dopri5", "_ZN4bode25dopri5_bwd_kernel_boundedINS_8FHNPointILi5EE"
     "EENS_5Tsit5EEEvNT_4ArgsENS4_5GradsEPKfS8_PKiS8_iiPf", 80, 0,
     "dopri5_bwd FHNPoint Tsit5"),
    # K9 (dopri5_step_kernel over GPPoint<8>)
    ("gp_dopri5_step", "_ZN4bode18dopri5_step_kernelINS_7GPPointILi8EEENS_"
     "6Dopri5EEEvNT_4ArgsEPKfiiiNS_9SolveArgsENS_9StepStateEPf", 80, 0,
     "dopri5_step GPPoint Dopri5"),
])
def test_ptxas_summary_names_the_redesigned_solves_and_spiral_replay(
        family, mangled, regs, smem, name):
    """The per-point GP solves (record and no-record) and per-step solver,
    the MLP forwards, the spiral's forward and replay and the
    FitzHugh-Nagumo forward and replay parse to the names
    chip_smoke.OCCUPANCY_BLOCKS keys."""
    log = (f"ptxas info    : Compiling entry function '{mangled}' for "
           "'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           f"ptxas info    : Used {regs} registers, used 1 barriers, {smem} "
           "bytes smem\n")
    assert chip_smoke.ptxas_summary(family, (5, 0), log) == [
        (name, regs, 0, 0, smem)]
    assert (family, name) in chip_smoke.OCCUPANCY_BLOCKS


def test_ptxas_summary_names_k8_by_its_feature_chunk():
    """K8's instances (svgd_phi_kernel<kFq>, 32 kFq features a lane
    group) and its combine: the SVGD path's 96-feature instance is keyed in
    chip_smoke.OCCUPANCY_BLOCKS; the combine has its own shared-memory
    kind."""
    log = "".join(
        f"ptxas info    : Compiling entry function '{mangled}' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers{smem}\n"
        for mangled, regs, smem in (
            ("_ZN4bode15svgd_phi_kernelILi3EEEvPKfS2_S2_iiiPf", 127,
             ", 43392 bytes smem"),
            ("_ZN4bode15svgd_phi_kernelILi1EEEvPKfS2_S2_iiiPf", 126,
             ", 43392 bytes smem"),
            ("_ZN4bode23svgd_phi_combine_kernelEPKfS1_S1_iiiPf", 32, "")))
    got = chip_smoke.ptxas_summary("svgd_phi", (), log)
    assert got == [("svgd_phi 96", 127, 0, 0, 43392),
                   ("svgd_phi 32", 126, 0, 0, 43392),
                   ("svgd_phi combine", 32, 0, 0, 0)]
    assert [chip_smoke.kernel_kind(g[0]) for g in got] == [
        "phi", "phi", "combine"]
    assert chip_smoke.OCCUPANCY_BLOCKS["svgd_phi", "svgd_phi 96"] == (128,
                                                                       32)


def test_ptxas_summary_names_the_per_point_rk4_forward():
    """K4 (gp_rk4_fwd_kernel on GPPoint<8>): its buffers are dynamic, so
    ptxas reports no shared memory, and chip_smoke.block_smem takes the
    shape check's arithmetic (7,200 B at N=5, M=36) for its occupancy."""
    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN4bode17gp_rk4_fwd_kernelEPKfS1_S1_S1_iiffPf' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 56 registers, used 1 barriers\n")
    assert chip_smoke.ptxas_summary("gp_rk4", (5, 36), log) == [
        ("gp_rk4_fwd", 56, 0, 0, 0)]
    assert ("gp_rk4", "gp_rk4_fwd") in chip_smoke.OCCUPANCY_BLOCKS
    assert chip_smoke.OCCUPANCY_BLOCKS["gp_rk4", "gp_rk4_fwd"] == (128, 24)
    assert chip_smoke.block_smem("gp_rk4", (5, 36), "gp_rk4_fwd", 0) == 7200


@pytest.mark.parametrize("family,shape,name,static,smem", [
    # dynamic: the arithmetic, or a tree's static bytes where they are more
    ("gp_rk4", (5, 36), "gp_rk4_fwd", 18720, 18720),
    ("gp_rk4", (5, 64), "gp_rk4_bwd", 0, 66048),
    ("gp_dopri5", (5, 49), "dopri5_bwd GPPoint Dopri5", 0, 51784),
    ("gp_dopri5", (5, 49), "dopri5_fwd GPPoint Tsit5 record", 0, 9800),
    ("gp_dopri5_step", (5, 36), "dopri5_step GPPoint Dopri5", 0, 7200),
    # static: ptxas's bytes
    ("mlp_rk4", (5, 32), "mlp_rk4_bwd", 39872, 39872),
    ("spiral_dopri5", (5, 50), "dopri5_fwd SpiralDopri5 Dopri5 record", 0,
     0),
    ("spiral_dopri5", (5, 50), "dopri5_fwd SpiralDopri5Fwd Dopri5 record",
     192, 192),
    ("fhn_dopri5", (5,), "dopri5_fwd FHNPoint Tsit5 no-record", 0, 0),
    ("svgd_phi", (), "svgd_phi 96", 43392, 43392),
])
def test_block_smem(family, shape, name, static, smem):
    assert chip_smoke.block_smem(family, shape, name, static) == smem
