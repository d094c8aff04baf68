#!/usr/bin/env python3
"""Time one field's kernels of this tree against other trees' (the parent
commit, unpacked with `git archive`), in one process on one NVIDIA GPU:

    python3 scripts/time_backward.py --field gp --parent build/parent
    python3 scripts/time_backward.py --field mlp --parent build/parent
    python3 scripts/time_backward.py --field spiral --parent build/parent
    python3 scripts/time_backward.py --field fhn --parent build/parent
    python3 scripts/time_backward.py --field svgd --parent build/parent
    python3 scripts/time_backward.py --field gp --grid 7   # this tree alone

`--grid G` puts the GP field on a G x G inducing grid (M = G^2; 6 by
default, the main path's); without `--parent` (a parent whose kernels
cannot take the shape, say) only this tree's kernels are timed.

--field gp: the whole adaptive solve without records (K1,
`gp_dopri5_fwd` record=0) and with them (K2, record=1), each at DOPRI5 and
TSIT5, K3 over the GP field (`gp_dopri5_bwd`, the replay backward, at
DOPRI5 and TSIT5), K4 (`gp_rk4_fwd`, the rk4 forward), K5
(`gp_rk4_bwd`, the rk4 reverse sweep) and K9 (`gp_dopri5_step`, a whole
solve of the per-step solver `gp_dopri5_solve`, its host side included:
every output interval launched at once and one read a solve, and again
launch by launch with a read after each; a tree whose K9 takes one masked
step a launch, before the kernel of one output interval a launch, runs
under the host loop it was written for, kept here as
`k9_one_step_a_launch`).  --field
mlp: K6 (`mlp_rk4_fwd`), MLP K2 (`mlp_dopri5_fwd`, with and without
records, each at DOPRI5 and TSIT5), K7 (`mlp_rk4_bwd`) and MLP K3
(`mlp_dopri5_bwd`, DOPRI5 and TSIT5).  --field spiral: spiral K2
(`spiral_dopri5_fwd`, with and without records) and spiral K3
(`spiral_dopri5_bwd`), each at DOPRI5 and TSIT5.  --field fhn: the
FitzHugh-Nagumo field's K2 (`fhn_dopri5_fwd`, with and without records)
and K3 (`fhn_dopri5_bwd`), each at DOPRI5 and TSIT5.  --field svgd: K8
(`svgd_phi`, with its combine) at 1,024, 4,096 and 16,384 particles of
d = 74, on the SVGD ensemble and on N(0, 1) inputs, with each tree's and
the plain float32 matmul form's max-rel to a float64 truth and the matmul
form's time.

The trees' libraries keep the same C entry points, so each other tree's
are built from its own `csrc/` with this tree's nvcc flags into
`build/other_kernels/<label>/` (all nvcc processes started together) and
called on the same tensors.  `--tree LABEL=DIR` adds a tree beside the
parent.  The inputs are built as `chip_smoke.py` builds those of its
phases 1, 2 and 6 (GP), 7 and 10 (MLP) or 10 (spiral, H=50; FHN, on
FitzHugh-Nagumo data), with their own draws from seeded generators:
10,112 chains, N=5, T=60 to t=6, rtol=1e-7 / atol=1e-9, N(0, 1)
trajectory cotangents, the records of this tree's K2 (store_steps 128 for
the GP, spiral and FHN fields, 256 for the MLP) and the trajectories of
this tree's K4 or K6.

Prints each redesigned kernel's ptxas line, resident warps an SM and waves
(blocks over the blocks all SMs hold at once), then for each kernel and
tree: for a backward, whether the x0 cotangent is bit-equal to the
parent's (else its first differing component) and the largest max-rel of
the weight cotangents to the parent's; for K6 and the GP, MLP, spiral and
FHN solves, whether the trajectories (and the solves' counters, end times
and records) are bit-equal to the parent's (K4 too, and K9's trajectories
and counters, with each tree's device time a solve: CUDA events around
its launches, summed), else the trajectories' max-rel, and each tree's
mean NFE;
for MLP K2, this tree's bound (chip_smoke.adaptive_bounds from its step
counts) and one plain solve's time; and the time by CUDA events (20
launches after 10) in turns: parent, the other trees, this tree, and back
in reverse order.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root's smoke test: its helpers)

N_CHAINS, HIDDEN, N, T = chip_smoke.N_CHAINS, chip_smoke.HIDDEN, 5, 60
SPIRAL_HIDDEN = chip_smoke.SPIRAL_HIDDEN
FIELDS = ("gp", "mlp", "spiral", "fhn", "svgd")
SVGD_SIZES = (1024, 4096, 16384)


def field_specs(field, grid=6):
    """The (family, shape) libraries of a field's kernels: the GP field's
    on a grid x grid inducing grid."""
    M = grid * grid
    return {"gp": [("gp_dopri5", (N, M)), ("gp_rk4", (N, M)),
                   ("gp_dopri5_step", (N, M))],
            "mlp": [("mlp_rk4", (N, HIDDEN)), ("mlp_dopri5", (N, HIDDEN))],
            "spiral": [("spiral_dopri5", (N, SPIRAL_HIDDEN))],
            "fhn": [("fhn_dopri5", (N,))],
            "svgd": [("svgd_phi", ())]}[field]


def block_shape(csrc: Path, field: str):
    """{kernel: (threads, chains) a block} of a tree's rk4 ("rk4") and
    replay ("dopri5") backward kernels, rk4 forward ("rk4_fwd") and
    adaptive forwards ("fwd"), read from its sources: the GP field's
    per-point kernels (`struct GPPoint` in gp_field.cuh, its kThreads; the
    forwards too where GPPoint has `norm_sums`, K4 where gp_rk4.cu steps
    one point, `rk4_step<2>`) or its chain-per-thread ones (64); the MLP
    field's chains a block of K3 (`MLPWarpChains<2` or `kChains = 2` in
    mlp_field.cuh: two; else four), and its forwards' `kFwdWarps` chains a
    block (before it, four for K6 and K3's for K2); the spiral's four (one
    warp a chain); the FitzHugh-Nagumo forward's one point a thread
    (`struct FHNPoint` in fhn_field.cuh: 128 threads, 32 // N chains a
    warp) or one chain a thread (64), and its backward's the same where it
    is built on `FHNBwd`; and the GP per-step solver's (K9, "step") one
    point a thread where gp_dopri5_step.cu takes `GPReplayPoint` (or
    `GPFwdPoint`, GPPoint<8> at this shape)."""
    if field == "gp":
        src = (csrc / "gp_field.cuh").read_text()
        threads = re.search(r"static constexpr int kThreads = (\d+);", src)
        threads = int(threads.group(1)) if threads else 128
        point = (threads, threads // 32 * (32 // N))
        per_point = "struct GPPoint" in src
        shape = point if per_point else (64, 64)
        rk4_fwd = "rk4_step<2>" in (csrc / "gp_rk4.cu").read_text()
        step_src = (csrc / "gp_dopri5_step.cu").read_text()
        step = "GPReplayPoint" in step_src or "GPFwdPoint" in step_src
        return {"rk4": shape, "dopri5": shape,
                "fwd": point if "norm_sums" in src else (64, 64),
                "rk4_fwd": point if rk4_fwd else (64, 64),
                "step": point if step else (64, 64)}
    if field == "spiral":
        return {"dopri5": (128, 4), "fwd": (128, 4)}
    if field == "fhn":
        src = (csrc / "fhn_field.cuh").read_text()
        point = (128, 128 // 32 * (32 // N))
        return {"dopri5": point if "FHNBwd" in src else (64, 64),
                "fwd": point if "struct FHNPoint" in src else (64, 64)}
    if field == "svgd":
        src = (csrc / "svgd_phi.cu").read_text()
        rows = int(re.search(r"constexpr int kRows = (\d+);", src).group(1))
        threads = re.search(r"constexpr int kThreads = (\d+);", src)
        return {"svgd": (int(threads.group(1)) if threads else 4 * rows,
                         rows)}
    src = (csrc / "mlp_field.cuh").read_text()
    two = re.search(r"kChains = 2;|MLPWarpChains<(warps_fitting\()?2\b", src)
    bwd = (64, 2) if two else (128, 4)
    fwd = re.search(r"constexpr int kFwdWarps = (\d+);", src)
    fwd = (32 * int(fwd.group(1)), int(fwd.group(1))) if fwd else None
    return {"rk4": (128, 4), "dopri5": bwd, "rk4_fwd": fwd or (128, 4),
            "fwd": fwd or bwd}


def build_others(trees, specs):
    """Each other tree's libraries of `specs`: {label: {family: (ctypes
    library, nvcc log)}}.  One nvcc per source, all started together."""
    from bayesian_ode_tpu_torch.ops import _build

    jobs = []
    for label, csrc in trees.items():
        out = ROOT / "build" / "other_kernels" / label
        out.mkdir(parents=True, exist_ok=True)
        for family, shape in specs:
            fam = _build.FAMILIES[family]
            defines = [f"-D{n}={v}" for n, v in zip(fam.defines, shape)]
            procs = []
            for src in fam.sources:
                obj = out / f"{Path(src).stem}.o"
                procs.append((obj, subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, *defines,
                     f"-I{csrc}", "-c", str(csrc / src), "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            jobs.append((label, family, out / f"{family}.so", procs))
    libs = {label: {} for label in trees}
    for label, family, so, procs in jobs:
        log = "".join(p.communicate()[0] for _, p in procs)
        if any(p.returncode for _, p in procs):
            raise RuntimeError(f"nvcc failed for {label}'s {family}:\n{log}")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:2], "-shared",
                        "-o", str(so), *(str(o) for o, _ in procs)],
                       check=True)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _build.FAMILIES[family].entry_points.items():
            if not hasattr(lib, name):      # an entry point this tree lacks
                continue
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[label][family] = (lib, log)
    return libs


def print_occupancy(label, family, shape, log, blocks):
    for name, regs, st, ld, smem in chip_smoke.ptxas_summary(family, shape,
                                                             log):
        kind = ("rk4" if name.endswith("rk4_bwd") else
                "rk4_fwd" if name.endswith("rk4_fwd") else
                "dopri5" if name.startswith("dopri5_bwd") else
                "fwd" if name.startswith("dopri5_fwd") else
                "step" if name.startswith("dopri5_step") else
                "svgd" if name.startswith("svgd_phi")
                and not name.endswith("combine") else None)
        if kind == "svgd":
            # K8's blocks are particle rows; a tree whose buffers are
            # dynamic reports none to ptxas
            threads, rows = blocks[kind]
            warps = (f"{chip_smoke.warps_per_sm(regs, smem, threads)} warps "
                     "an SM" if smem else "dynamic shared memory")
            print(f"    {label} {name}: {warps} ({threads} threads and "
                  f"{rows} rows a block, {regs} registers, spills {st}/{ld}"
                  f" B, {smem} B static shared memory)")
        elif kind in blocks:
            threads, chains = blocks[kind]
            smem = chip_smoke.block_smem(family, shape, name, smem)
            warps, waves = chip_smoke.occupancy(regs, smem, threads, chains,
                                                N_CHAINS)
            print(f"    {label} {name}: {warps} warps an SM, {waves:.2f} "
                  f"waves ({threads} threads and {chains} chains a block, "
                  f"{smem} B shared memory)")


def solve(lib, family, w, scalars, x0, f0, dt0, ts, record, method, store,
          stream):
    """One launch of a family's adaptive forward (K1/K2) at rtol=1e-7 /
    atol=1e-9 and the "i" controller: (trajectories, nfe, nacc, nrej, t1,
    records or None)."""
    import torch

    from bayesian_ode_tpu_torch.ops import _build

    C, T = f0.shape[0], ts.shape[0]
    dev, f32, i32 = f0.device, torch.float32, torch.int32
    ys = torch.empty((T,) + tuple(f0.shape), dtype=f32, device=dev)
    nfe, nacc, nrej = (torch.empty(C, dtype=i32, device=dev)
                       for _ in range(3))
    t1 = torch.empty(C, dtype=f32, device=dev)
    rec = (torch.empty((store, f0.shape[1] * 2 + 2, C), dtype=f32,
                       device=dev) if record else None)
    _build.check(getattr(lib, f"{family}_fwd")(
        int(record), _build.TABLEAUS.index(method),
        *(x.data_ptr() for x in w), *scalars, x0.data_ptr(), f0.data_ptr(),
        dt0.data_ptr(), ts.data_ptr(), C, T, chip_smoke.RTOL,
        chip_smoke.ATOL, 0.9, 10.0, 0.2, 100_000, 0,
        store if record else 0, ys.data_ptr(), nfe.data_ptr(),
        nacc.data_ptr(), nrej.data_ptr(), t1.data_ptr(),
        rec.data_ptr() if record else None, stream), f"{family}_fwd")
    return ys, nfe, nacc, nrej, t1, rec


def gp_kernels(dev, stream, grid=6):
    """{label: (kind, run(libs) -> outputs)} of the GP field's kernels, on
    chip_smoke.py's phase 1, 2 and 6 inputs: the solves K1 and K2 ("exact",
    the outputs of `solve`), K4 ("exact": trajectories), K9 ("k9": its
    trajectories and counters, and its device time) and the backward
    kernels ("bwd", the x0 cotangent last)."""
    import torch

    from bayesian_ode_tpu_torch.models import kernel_regression as kr
    from bayesian_ode_tpu_torch.models import make_dataset
    from bayesian_ode_tpu_torch.ops import _build
    from bayesian_ode_tpu_torch.ops import fused_adaptive as fa
    from bayesian_ode_tpu_torch.ops import gp_dopri5 as tg
    from bayesian_ode_tpu_torch.ops import gp_rk4
    from bayesian_ode_tpu_torch.ops.gp_dopri5 import (
        _pack_initial,
        gp_dopri5_solve,
    )
    from bayesian_ode_tpu_torch.ops.gp_field import gp_field

    f32 = torch.float32
    data = make_dataset(seed=2, ode="vdp", N=N, T=T, t_max=6.0, noise=0.05,
                        x0_scale=1.5)
    static = kr.make_static(kr.make_inducing_grid(data["Y"], M=grid),
                            sf=1.0, ell=0.75)
    M = grid * grid
    U0 = kr.init_params(data["Y"], data["t"], static, noise=0.05)["U"]
    gen = torch.Generator(device=dev).manual_seed(0)
    U = U0.to(dev, f32)[None] + 3e-3 * torch.randn(
        (N_CHAINS, M, 2), generator=gen, device=dev, dtype=f32)
    A = torch.einsum("mk,ckd->cmd", static.KzzinvL.to(dev, f32),
                     U).contiguous()
    Z = static.Z.to(dev, f32).contiguous()
    x0 = data["x0"].to(dev, f32).contiguous()
    ts = data["t"].to(dev, f32).contiguous()
    dts = torch.diff(ts).contiguous()
    sf, ell = float(static.sf), float(static.ell)
    scalars = (sf * sf, 0.5 / (ell * ell), 1.0 / (ell * ell))
    rtol, atol = chip_smoke.RTOL, chip_smoke.ATOL
    x0b, f0, dt0 = _pack_initial(A, x0, Z, sf, ell, rtol, atol)
    f0, dt0 = f0.contiguous(), dt0.contiguous()
    recs = {}
    for method in ("dopri5", "tsit5"):
        _, _, nacc, _, _, rec = fa.fwd(
            gp_field(sf, ell), (A, Z), x0b, f0, dt0, ts, rtol, atol, 0.9,
            10.0, 0.2, 100_000, "i", record=True,
            store_steps=chip_smoke.STORE_STEPS, method=method)
        recs[method] = (rec, nacc)
    ys = gp_rk4.gp_rk4_fwd(A, Z, x0, dts, sf, ell)
    g3, g5 = (torch.randn((T, N_CHAINS, N, 2), generator=gen, device=dev,
                          dtype=f32) for _ in range(2))

    def k3(libs, method):
        rec, nacc = recs[method]
        Abar = torch.empty_like(A)
        lbar = torch.empty((N_CHAINS, N, 2), dtype=f32, device=dev)
        _build.check(libs["gp_dopri5"].gp_dopri5_bwd(
            _build.TABLEAUS.index(method), A.data_ptr(), Z.data_ptr(),
            *scalars, Abar.data_ptr(), ts.data_ptr(), rec.data_ptr(),
            nacc.data_ptr(), g3.data_ptr(), N_CHAINS, T, lbar.data_ptr(),
            stream), "gp_dopri5_bwd")
        return Abar, lbar

    def k4(libs):
        out = torch.empty_like(ys)
        _build.check(libs["gp_rk4"].gp_rk4_fwd(
            A.data_ptr(), x0.data_ptr(), Z.data_ptr(), dts.data_ptr(),
            N_CHAINS, T, *scalars[:2], out.data_ptr(), stream), "gp_rk4_fwd")
        return (out,)

    def k9(libs, one_pass=True):
        """A whole solve of the per-step solver over a tree's K9: (ys, nfe,
        nacc, nrej, its device ms by CUDA events around each launch's C
        call).  A tree with gp_dopri5_intervals: gp_dopri5_solve (every
        interval launched at once, one read a solve), or with one_pass
        False its launch-by-launch loop (a read after each launch)."""
        events = []
        lib = chip_smoke.TimedLibrary(libs["gp_dopri5_step"], events)
        if not hasattr(lib.lib, "gp_dopri5_intervals"):
            out = k9_one_step_a_launch(lib, A, Z, x0, ts, static, scalars,
                                       stream)
        elif one_pass:
            load = _build.load_library
            _build.load_library = lambda family, shape: lib
            try:
                ys9, st = gp_dopri5_solve(A, x0, ts, static, rtol=rtol,
                                          atol=atol)
            finally:
                _build.load_library = load
            out = ys9, st["nfe"], st["n_accepted"], st["n_rejected"]
        else:
            state, ys9 = tg._initial((A, Z), x0, ts, static, rtol, atol)()
            flags = torch.empty(2, dtype=torch.int32, device=dev)
            state = tg._relaunching(
                state, ys9, ts, 100_000, 1,
                lambda state, ys, k, cap: tg._interval_launch(
                    state, ys, ts, k, cap, lib, (A, Z), scalars, flags,
                    rtol, atol, 0.9, 10.0, 0.2))
            out = ys9, state.nfe, state.nacc, state.nrej
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in events)
        K9_DEVICE_MS.setdefault(id(libs), []).append(ms)
        return out + (ms,)

    def k5(libs):
        Abar = torch.empty_like(A)
        lbar = torch.empty((N_CHAINS, N, 2), dtype=f32, device=dev)
        _build.check(libs["gp_rk4"].gp_rk4_bwd(
            A.data_ptr(), Z.data_ptr(), dts.data_ptr(), ys.data_ptr(),
            g5.data_ptr(), N_CHAINS, T, *scalars, Abar.data_ptr(),
            lbar.data_ptr(), stream), "gp_rk4_bwd")
        return Abar, lbar

    def fwd(libs, record, method):
        return solve(libs["gp_dopri5"], "gp_dopri5", (A, Z), scalars, x0,
                     f0, dt0, ts, record, method, chip_smoke.STORE_STEPS,
                     stream)

    return {"K1 DOPRI5": ("exact", lambda libs: fwd(libs, False, "dopri5")),
            "K1 TSIT5": ("exact", lambda libs: fwd(libs, False, "tsit5")),
            "K2 GP DOPRI5": ("exact",
                             lambda libs: fwd(libs, True, "dopri5")),
            "K2 GP TSIT5": ("exact", lambda libs: fwd(libs, True, "tsit5")),
            "K3 GP DOPRI5": ("bwd", lambda libs: k3(libs, "dopri5")),
            "K3 GP TSIT5": ("bwd", lambda libs: k3(libs, "tsit5")),
            "K4": ("exact", k4), "K5": ("bwd", k5),
            "K9": ("k9", k9),
            "K9 launch by launch": ("k9",
                                    lambda libs: k9(libs, one_pass=False))}


# Each K9 solve's device ms, by the id of the libraries it ran on: main
# prints the median of an entry's runs but the first (a library's first
# run includes its kernels' loading) and clears it
K9_DEVICE_MS = {}

# The C signature of a K9 of one masked step a launch
ONE_STEP_API = ([ctypes.c_void_p] * 2 + [ctypes.c_float] * 3
                + [ctypes.c_void_p] + [ctypes.c_int] * 4
                + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 11)


def k9_one_step_a_launch(lib, A, Z, x0, ts, static, scalars, stream,
                         max_steps=100_000):
    """The per-step solver over a K9 of one masked step a launch (`lib`, a
    chip_smoke.TimedLibrary), with the host loop that launched it: per
    output interval, launches while a chain is short of ts[k] and no chain
    has taken max_steps steps, each followed by a two-int read, then the
    dense output at ts[k] on the host.  Returns (ys, nfe, nacc, nrej)."""
    from bisect import bisect_right

    import torch

    from bayesian_ode_tpu_torch.ops import _build
    from bayesian_ode_tpu_torch.ops import gp_dopri5 as tg

    lib.lib.gp_dopri5_step.argtypes = ONE_STEP_API
    lib.lib.gp_dopri5_step.restype = ctypes.c_int
    rtol, atol = chip_smoke.RTOL, chip_smoke.ATOL
    state = tg._step_init((A, Z), x0, ts, static, rtol, atol)
    flags = torch.empty(2, dtype=torch.int32, device=A.device)
    times = ts.tolist()
    pending, taken = bisect_right(times, times[0]), 0
    ys = [state.y.clone()]
    for k in range(1, len(times)):
        while pending <= k and taken < max_steps:
            _build.check(lib.gp_dopri5_step(
                A.data_ptr(), Z.data_ptr(), *scalars, ts.data_ptr(), k,
                len(times), A.shape[0], 1, rtol, atol, 0.9, 10.0, 0.2,
                *(x.data_ptr() for x in state), flags.data_ptr(), stream),
                "gp_dopri5_step")
            pending, taken = flags.tolist()
        ys.append(tg._interp_eval(state, ts[k]))
    return torch.stack(ys), state.nfe, state.nacc, state.nrej


def mlp_kernels(dev, stream):
    """{label: (kind, run(libs) -> outputs)} of the MLP field's kernels, on
    chip_smoke.py's phase 7 and 10 inputs: K6 ("exact", its trajectories),
    MLP K2 ("exact", the outputs of `solve`; with a note of this tree's
    bound and the plain solve's time) and the backward kernels ("bwd", the
    x0 cotangent last)."""
    import torch

    from bayesian_ode_tpu_torch.models import make_dataset, mlp
    from bayesian_ode_tpu_torch.ops import _build
    from bayesian_ode_tpu_torch.ops import fused_adaptive as fa
    from bayesian_ode_tpu_torch.ops import fused_field as ff
    from bayesian_ode_tpu_torch.ops import mlp_rk4
    from bayesian_ode_tpu_torch.ops.mlp_dopri5 import mlp_field

    data = make_dataset(seed=2, ode="vdp", N=N, T=T, t_max=6.0, noise=0.05,
                        x0_scale=1.5)
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    params0 = mlp.init_mlp(torch.Generator().manual_seed(0),
                           [2, HIDDEN, HIDDEN, 2], dtype=f32)
    w = tuple((x.to(dev)[None] + 0.005 * torch.randn(
        (N_CHAINS,) + tuple(x.shape), generator=gen, device=dev)
    ).contiguous() for layer in params0 for x in (layer["w"], layer["b"]))
    x0, ts = data["x0"].to(dev, f32), data["t"].to(dev, f32)
    dts = torch.diff(ts).contiguous()
    g7, g3 = (torch.randn((T, N_CHAINS, N, 2), generator=gen, device=dev,
                          dtype=f32) for _ in range(2))
    ys = mlp_rk4.mlp_rk4_fwd(w, x0.contiguous(), dts)
    field = mlp_field(HIDDEN)
    rtol, atol = chip_smoke.RTOL, chip_smoke.ATOL
    x0b, f0, dt0 = ff._start(field, w, x0, rtol, atol)
    recs = {}
    for method in ("dopri5", "tsit5"):
        _, _, nacc, _, _, rec = fa.fwd(field, w, x0b, f0, dt0, ts, rtol, atol,
                                       0.9, 10.0, 0.2, 100_000, "i",
                                       record=True, store_steps=256,
                                       method=method)
        recs[method] = (rec, nacc)
    x0c, f0c, dt0c = x0.contiguous(), f0.contiguous(), dt0.contiguous()

    def k7(libs):
        wbar = tuple(torch.empty_like(x) for x in w)
        lbar = torch.empty((N_CHAINS, N, 2), dtype=f32, device=dev)
        _build.check(libs["mlp_rk4"].mlp_rk4_bwd(
            *(x.data_ptr() for x in w), dts.data_ptr(), ys.data_ptr(),
            g7.data_ptr(), N_CHAINS, T, *(x.data_ptr() for x in wbar),
            lbar.data_ptr(), stream), "mlp_rk4_bwd")
        return wbar + (lbar,)

    def k3(libs, method):
        rec, nacc = recs[method]
        wbar = tuple(torch.empty_like(x) for x in w)
        lbar = torch.empty((N_CHAINS, N, 2), dtype=f32, device=dev)
        _build.check(libs["mlp_dopri5"].mlp_dopri5_bwd(
            _build.TABLEAUS.index(method), *(x.data_ptr() for x in w),
            *(x.data_ptr() for x in wbar), ts.data_ptr(), rec.data_ptr(),
            nacc.data_ptr(), g3.data_ptr(), N_CHAINS, T, lbar.data_ptr(),
            stream), "mlp_dopri5_bwd")
        return wbar + (lbar,)

    def k6(libs):
        out = torch.empty_like(ys)
        _build.check(libs["mlp_rk4"].mlp_rk4_fwd(
            *(x.data_ptr() for x in w), x0c.data_ptr(), dts.data_ptr(),
            N_CHAINS, T, out.data_ptr(), stream), "mlp_rk4_fwd")
        return (out,)

    def k2(libs, record, method):
        return solve(libs["mlp_dopri5"], "mlp_dopri5", w, (), x0c, f0c,
                     dt0c, ts, record, method, 256, stream)

    def k2_note(out, method):
        """This tree's bound from its step counts, and one plain solve."""
        nacc, nrej = out[2].sum(), out[3].sum()
        (b, by), _ = chip_smoke.adaptive_bounds(
            "mlp", HIDDEN, N_CHAINS, N, T, chip_smoke.nbytes(w), 0,
            int(nacc + nrej), int(nacc), record=out[5] is not None)
        plain = chip_smoke.cuda_ms(lambda: fa.fwd_plain(
            field.make_rhs(w), x0b, f0, dt0, ts, rtol, atol, 0.9, 10.0,
            0.2, 100_000, "i", tableau=fa.TABLEAUS[method]), 1)
        return f"bound {b:.3f} ms ({by}); plain {plain:.1f} ms"

    return {"K6": ("exact", k6), **solve_kernels("MLP K2", k2, k2_note),
            "K7": ("bwd", k7),
            "MLP K3 DOPRI5": ("bwd", lambda libs: k3(libs, "dopri5")),
            "MLP K3 TSIT5": ("bwd", lambda libs: k3(libs, "tsit5"))}


def spiral_kernels(dev, stream):
    """field_kernels of the spiral field at H=50 on chip_smoke.py's phase
    10 inputs (its start weights jittered by 0.005 a chain)."""
    import torch

    from bayesian_ode_tpu_torch.models import make_dataset
    from bayesian_ode_tpu_torch.models import spiral as spiral_model
    from bayesian_ode_tpu_torch.ops.spiral_dopri5 import spiral_field

    data = make_dataset(seed=2, ode="vdp", N=N, T=T, t_max=6.0, noise=0.05,
                        x0_scale=1.5)
    gen = torch.Generator(device=dev).manual_seed(0)
    sp0 = spiral_model.init_params(torch.Generator().manual_seed(0),
                                   hidden=SPIRAL_HIDDEN)
    w = tuple((sp0[k].to(dev, torch.float32)[None] + 0.005 * torch.randn(
        (N_CHAINS,) + tuple(sp0[k].shape), generator=gen, device=dev)
    ).contiguous() for k in ("w1", "b1", "w2", "b2"))
    return field_kernels("spiral", spiral_field(), w, data, gen, dev,
                         stream)


def fhn_kernels(dev, stream):
    """field_kernels of the FitzHugh-Nagumo field on chip_smoke.py's phase
    10 inputs (FitzHugh-Nagumo data, theta at (0.2, 0.2, 3.0) jittered by
    0.005 a chain)."""
    import torch

    from bayesian_ode_tpu_torch.models import make_dataset
    from bayesian_ode_tpu_torch.ops.fhn_dopri5 import fhn_field

    data = make_dataset(seed=2, ode="fhn", N=N, T=T, t_max=6.0, noise=0.05,
                        x0_scale=1.5)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = tuple((torch.full((N_CHAINS,), v, device=dev) + 0.005 * torch.randn(
        (N_CHAINS,), generator=gen, device=dev)).contiguous()
        for v in (0.2, 0.2, 3.0))
    return field_kernels("FHN", fhn_field(), w, data, gen, dev, stream)


def field_kernels(label, field, w, data, gen, dev, stream):
    """{label: (kind, run(libs) -> outputs)} of a fused-engine field's
    kernels: K2 ("exact", the outputs of `solve`, with and without
    records) and K3 ("bwd", on this tree's K2 records, N(0, 1) trajectory
    cotangents from gen), each at DOPRI5 and TSIT5, from the data's x0 to
    its output times, store_steps 128."""
    import torch

    from bayesian_ode_tpu_torch.ops import _build
    from bayesian_ode_tpu_torch.ops import fused_adaptive as fa
    from bayesian_ode_tpu_torch.ops import fused_field as ff

    f32 = torch.float32
    family = f"{field.name}_dopri5"
    x0, ts = data["x0"].to(dev, f32).contiguous(), data["t"].to(dev, f32)
    store = chip_smoke.STORE_STEPS
    rtol, atol = chip_smoke.RTOL, chip_smoke.ATOL
    _, f0, dt0 = ff._start(field, w, x0, rtol, atol)
    f0, dt0 = f0.contiguous(), dt0.contiguous()
    g = torch.randn((T, N_CHAINS, N, 2), generator=gen, device=dev,
                    dtype=f32)
    recs = {}
    for method in ("dopri5", "tsit5"):
        _, _, nacc, _, _, rec = fa.fwd(field, w, x0.expand(N_CHAINS, N, 2),
                                       f0, dt0, ts, rtol, atol, 0.9, 10.0,
                                       0.2, 100_000, "i", record=True,
                                       store_steps=store, method=method)
        recs[method] = (rec, nacc)

    def k2(libs, record, method):
        return solve(libs[family], family, w, (), x0, f0, dt0, ts, record,
                     method, store, stream)

    def k3(libs, method):
        rec, nacc = recs[method]
        wbar = tuple(torch.empty_like(x) for x in w)
        lbar = torch.empty((N_CHAINS, N, 2), dtype=f32, device=dev)
        _build.check(getattr(libs[family], f"{family}_bwd")(
            _build.TABLEAUS.index(method), *(x.data_ptr() for x in w),
            *(x.data_ptr() for x in wbar), ts.data_ptr(), rec.data_ptr(),
            nacc.data_ptr(), g.data_ptr(), N_CHAINS, T, lbar.data_ptr(),
            stream), f"{family}_bwd")
        return wbar + (lbar,)

    return {**solve_kernels(f"{label} K2", k2),
            f"{label} K3 DOPRI5": ("bwd", lambda libs: k3(libs, "dopri5")),
            f"{label} K3 TSIT5": ("bwd", lambda libs: k3(libs, "tsit5"))}


def solve_kernels(label, k2, note=None):
    """{label: ("exact", run[, note])} of a field's K2 with and without
    records at each tableau: k2(libs, record, method) the launch,
    note(outputs, method) a line about this tree's outputs."""
    return {f"{label} {method.upper()}{tag}": (
        "exact", lambda libs, r=record, m=method: k2(libs, r, m),
        *((lambda out, m=method: note(out, m),) if note else ()))
        for tag, record in (("", True), (" no-record", False))
        for method in ("dopri5", "tsit5")}


def svgd_kernels(dev, stream):
    """{label: (kind, run(libs) -> (phi, float64 truth), note)} of K8 at
    SVGD_SIZES particles of d = 74: on the SVGD ensemble of chip_smoke.py's
    phase 13 (the GP posterior's start jittered by 0.005, scores of the
    fused rk4 potential) and on N(0, 1) particles and scores (phase 14),
    each at the median bandwidth.  A tree whose library lacks
    `svgd_phi_splits` (before the column splits) is called with its own
    signature."""
    import torch

    from bayesian_ode_tpu_torch.models import kernel_regression as kr
    from bayesian_ode_tpu_torch.models import make_dataset
    from bayesian_ode_tpu_torch.ops import _build
    from bayesian_ode_tpu_torch.ops.gp_rk4 import make_fused_gp_potential
    from bayesian_ode_tpu_torch.ops.svgd_phi import svgd_phi_reference
    from bayesian_ode_tpu_torch.samplers import stein
    from bayesian_ode_tpu_torch.utils.pytree import ravel_pytree

    f32 = torch.float32
    data = make_dataset(seed=2, ode="vdp", N=N, T=T, t_max=6.0, noise=0.05,
                        x0_scale=1.5)
    static = kr.make_static(kr.make_inducing_grid(data["Y"], M=6), sf=1.0,
                            ell=0.75)
    p0 = kr.init_params(data["Y"], data["t"], static, noise=0.05)
    s32 = kr.GPVectorFieldStatic(
        Z=static.Z.to(dev, f32), KzzinvL=static.KzzinvL.to(dev, f32),
        Kzzinv=static.Kzzinv.to(dev, f32), sf=static.sf, ell=static.ell)
    pot = make_fused_gp_potential(s32, data["x0"].to(dev, f32),
                                  data["t"].to(dev, f32),
                                  data["Y"].to(dev, f32))
    unravel = ravel_pytree({k: p0[k].to(dev, f32)
                            for k in ("U", "logsn")})[1]

    def ensemble(n):
        g = torch.Generator(device=dev).manual_seed(n)
        U = p0["U"].to(dev, f32)[None] + 0.005 * torch.randn(
            (n, 36, 2), generator=g, device=dev)
        logsn = p0["logsn"].to(dev, f32)[None] + 0.005 * torch.randn(
            (n, 2), generator=g, device=dev)
        flat = torch.cat([U.reshape(n, -1), logsn], dim=1)  # leaf order
        x = flat.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(pot(unravel(x)).sum(), [x])
        return flat.contiguous(), (-grad).contiguous()

    def normal(n):
        g = torch.Generator(device=dev).manual_seed(8)
        return (torch.randn((n, 74), generator=g, device=dev),
                torch.randn((n, 74), generator=g, device=dev))

    old_api = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] * 2

    def case(X, S):
        gamma = stein.rbf_bandwidth(X, None, 256).to(f32).reshape(1)
        truth = svgd_phi_reference(X.double(), S.double(), gamma.double())
        n, d = X.shape

        def run(libs):
            lib = libs["svgd_phi"]
            out = torch.empty_like(X)
            if hasattr(lib, "svgd_phi_splits"):
                got = ctypes.c_int()
                _build.check(lib.svgd_phi_splits(n, d, ctypes.byref(got)),
                             "svgd_phi_splits")
                work = torch.empty((got.value, n, 2 * d + 1), dtype=f32,
                                   device=dev)
                status = lib.svgd_phi(X.data_ptr(), S.data_ptr(),
                                      gamma.data_ptr(), n, d, got.value,
                                      work.data_ptr(), out.data_ptr(),
                                      stream)
            else:
                lib.svgd_phi.argtypes = old_api
                status = lib.svgd_phi(X.data_ptr(), S.data_ptr(),
                                      gamma.data_ptr(), n, d, out.data_ptr(),
                                      stream)
            _build.check(status, "svgd_phi")
            return out, truth

        def note(out):
            plain = svgd_phi_reference(X, S, gamma)
            ms = chip_smoke.cuda_ms(lambda: svgd_phi_reference(X, S, gamma),
                                    10, warmup=2)
            return (f"max-rel to float64 {phi_error(out[0], truth):.3e}, "
                    f"plain float32 (matmul form) "
                    f"{phi_error(plain, truth):.3e}; matmul form {ms:.3f} "
                    f"ms")

        return "phi", run, note

    out = {}
    for n in SVGD_SIZES:
        out[f"K8 n={n} d=74 ensemble"] = case(*ensemble(n))
        out[f"K8 n={n} d=74 N(0,1)"] = case(*normal(n))
    return out


def phi_error(phi, truth):
    """max-rel of a float32 phi to the float64 truth."""
    return float((phi.double() - truth).abs().max() / truth.abs().max())


def first_difference(a, b):
    """(flat index, a's value, b's value) of the first element where a and
    b differ."""
    idx = int((a != b).flatten().nonzero()[0])
    return idx, float(a.flatten()[idx]), float(b.flatten()[idx])


def compare_bwd(out, base):
    """A backward's outputs, the x0 cotangent last, against the parent's."""
    import torch

    rel = max(chip_smoke.max_rel(x, y) for x, y in zip(out[:-1], base[:-1]))
    same = torch.equal(out[-1], base[-1])
    return (f"x0 cotangent bit-equal to the parent's: {same}"
            + ("" if same else " (first difference at flat index "
               "{} : {!r} vs {!r})".format(*first_difference(out[-1],
                                                              base[-1])))
            + f"; x0 cotangent max-rel "
            f"{chip_smoke.max_rel(out[-1], base[-1]):.3e}; weight "
            f"cotangents max-rel {rel:.3e}")


def compare_exact(out, base):
    """K4's or K6's trajectories, or the outputs of `solve`, against the
    parent's, each bit for bit (the records on the rows each chain
    wrote)."""
    import torch

    names = ("trajectories", "nfe", "nacc", "nrej", "t1", "records")
    out, base = list(out), list(base)
    if len(out) == len(names) and out[-1] is not None:
        rows = torch.arange(out[-1].shape[0], device=out[-1].device)
        for x, n in ((out, out[2]), (base, base[2])):
            x[-1] = torch.where(rows[:, None, None] < n[None, None, :],
                                x[-1], 0.0)
    same = {k: torch.equal(a, b) for k, a, b in zip(names, out, base)
            if a is not None}
    text = "bit-equal to the parent's: " + ", ".join(
        f"{k} {v}" for k, v in same.items())
    if not same["trajectories"]:
        text += (" (first difference at flat index {} : {!r} vs {!r})"
                 .format(*first_difference(out[0], base[0]))
                 + f"; trajectories max-rel "
                 f"{chip_smoke.max_rel(out[0], base[0]):.3e}")
    if len(out) == 1:
        return text
    return text + (f"; mean NFE {float(out[1].float().mean()):.3f}, parent "
                   f"{float(base[1].float().mean()):.3f}")


def compare_phi(out, base):
    """Two trees' phi (with the float64 truth): each one's max-rel to it,
    and whether they are bit-equal."""
    import torch

    return (f"max-rel to float64 {phi_error(out[0], out[1]):.3e}, parent "
            f"{phi_error(base[0], base[1]):.3e}; bit-equal to the parent's: "
            f"{torch.equal(out[0], base[0])}")


def compare_k9(out, base):
    """K9's trajectories and counters against the parent's, bit for bit
    (main prints the device times)."""
    return compare_exact(out[:4], base[:4])


COMPARE = {"bwd": compare_bwd, "exact": compare_exact,
           "phi": compare_phi, "k9": compare_k9}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--field", choices=FIELDS, required=True)
    ap.add_argument("--parent", type=Path,
                    help="root of the parent tree (git archive of a "
                    "commit); without it, this tree's kernels are timed "
                    "alone")
    ap.add_argument("--grid", type=int, default=6,
                    help="--field gp: the inducing grid's side (M = grid^2;"
                    " 6, the main path's, by default)")
    ap.add_argument("--tree", action="append", default=[],
                    metavar="LABEL=DIR", help="another tree to compare")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_backward: no CUDA device", file=sys.stderr)
        return 2
    from bayesian_ode_tpu_torch.models import kernel_regression as kr
    from bayesian_ode_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    kr.full_f32_matmul()
    pkg = Path("bayesian_ode_tpu_torch") / "csrc"
    others = {"parent": args.parent.resolve() / pkg} if args.parent else {}
    for spec in args.tree:
        label, _, root = spec.partition("=")
        others[label] = Path(root).resolve() / pkg
    specs = field_specs(args.field, args.grid)
    t0 = time.perf_counter()
    _build.build(specs)
    built = build_others(others, specs)
    print(f"builds: {time.perf_counter() - t0:.1f} s")
    libs = {label: {f: lib for f, (lib, _) in fams.items()}
            for label, fams in built.items()}
    libs["this"] = {f: _build.load_library(f, s) for f, s in specs}
    for label in libs:
        csrc = others.get(label, ROOT / pkg)
        for family, shape in specs:
            log = (_build.build_log(family, shape) if label == "this"
                   else built[label][family][1])
            print_occupancy(label, family, shape, log,
                            block_shape(csrc, args.field))

    stream = torch.cuda.current_stream(dev).cuda_stream
    if args.field == "gp":
        kernels = gp_kernels(dev, stream, args.grid)
    else:
        kernels = {"mlp": mlp_kernels, "spiral": spiral_kernels,
                   "fhn": fhn_kernels,
                   "svgd": svgd_kernels}[args.field](dev, stream)
    parent = "parent" in libs
    labels = [k for k in libs if k != "parent"]
    for name, (kind, run, *note) in kernels.items():
        outs = {label: run(libs[label]) for label in labels}
        if parent:
            base = run(libs["parent"])
            torch.cuda.synchronize()
            for label, out in outs.items():
                print(f"{name} {label}: " + COMPARE[kind](out, base))
        if note:
            print(f"{name}: " + note[0](outs["this"]))
        order = labels + labels[::-1]
        if parent:
            order = ["parent"] + order + ["parent"]
        ms = {label: [] for label in libs}
        for label in order:
            ms[label].append(chip_smoke.cuda_ms(lambda: run(libs[label]), 20,
                                                warmup=10))
        if kind == "k9":
            med = {label: statistics.median(K9_DEVICE_MS[id(lib)][1:])
                   for label, lib in libs.items()}
            K9_DEVICE_MS.clear()
            print(f"{name}: device ms a solve, median of the timed runs: "
                  + "; ".join(f"{k} {v:.3f}" for k, v in med.items())
                  + f" ({smi})")
        print(f"{name}: ms " + "; ".join(
            f"{label} {a:.3f} / {b:.3f}" for label, (a, b) in ms.items())
            + (f"; speed-up this tree "
               f"{sum(ms['parent']) / sum(ms['this']):.2f}x" if parent else "")
            + f" ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
