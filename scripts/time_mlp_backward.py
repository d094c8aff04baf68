#!/usr/bin/env python3
"""Time the MLP field's backward kernels of this tree against another
tree's (the parent commit, unpacked with `git archive`), in one process on
one NVIDIA GPU:

    python3 scripts/time_mlp_backward.py --parent build/parent

K7 (`mlp_rk4_bwd`, the rk4 reverse sweep) and MLP K3 (`mlp_dopri5_bwd`,
the replay backward, at DOPRI5 and TSIT5), and the forwards that share
their field, K6 (`mlp_rk4_fwd`) and MLP K2 (`mlp_dopri5_fwd`, recording,
DOPRI5; with each tree's mean NFE).  Both trees' libraries keep the
same C entry points, so the other tree's are built from its own `csrc/`
with this tree's nvcc flags into `build/parent_kernels/` and called on the
same tensors.  The inputs are built as `chip_smoke.py` builds those of
phases 7 and 10 (its own draws, from seeded generators): 10,112 chains of
the MLP 2-32-32-2 at the driver's start weights jittered by 0.005, N=5,
T=60 to t=6, N(0, 1) trajectory cotangents, and the records of this
tree's K2 at store_steps=256.  Prints each kernel's ptxas line and warps
per SM, the largest max-rel between the two trees' outputs, and each
kernel's time by CUDA events (20 launches after 10) in turns: parent,
this tree, this tree, parent.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root's smoke test: its helpers)

N_CHAINS, HIDDEN, N, T = chip_smoke.N_CHAINS, chip_smoke.HIDDEN, 5, 60
# threads a block of the backward kernels (csrc/mlp_field.cuh): K7 keeps
# 4 chains a block in both trees; MLP K3 4 in the parent, 2 here
THREADS = {"new": chip_smoke.MLP_BWD_THREADS,
           "parent": {name: 128 for name in chip_smoke.MLP_BWD_THREADS}}


def build_other(csrc: Path, family: str, shape):
    """The other tree's library of `family` at `shape`: (ctypes library,
    nvcc log)."""
    import ctypes

    from bayesian_ode_tpu_torch.ops import _build

    fam = _build.FAMILIES[family]
    out = ROOT / "build" / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"{family}_{'_'.join(map(str, shape))}.so"
    defines = [f"-D{n}={v}" for n, v in zip(fam.defines, shape)]
    procs = [(out / f"{Path(src).stem}.o",
              subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *defines,
                                f"-I{csrc}", "-c", str(csrc / src), "-o",
                                str(out / f"{Path(src).stem}.o")],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True))
             for src in fam.sources]
    log = "".join(p.communicate()[0] for _, p in procs)
    if any(p.returncode for _, p in procs):
        raise RuntimeError(
            f"nvcc failed for the other tree's {family}:\n{log}")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:2], "-shared", "-o",
                    str(so), *(str(o) for o, _ in procs)], check=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in fam.entry_points.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib, log


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of the other tree (git archive of a commit)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_mlp_backward: no CUDA device", file=sys.stderr)
        return 2
    from bayesian_ode_tpu_torch.models import kernel_regression as kr
    from bayesian_ode_tpu_torch.models import make_dataset, mlp
    from bayesian_ode_tpu_torch.ops import _build
    from bayesian_ode_tpu_torch.ops import fused_adaptive as fa
    from bayesian_ode_tpu_torch.ops import fused_field as ff
    from bayesian_ode_tpu_torch.ops import mlp_rk4
    from bayesian_ode_tpu_torch.ops.mlp_dopri5 import mlp_field

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    kr.full_f32_matmul()
    csrc = args.parent.resolve() / "bayesian_ode_tpu_torch" / "csrc"
    t0 = time.perf_counter()
    specs = [("mlp_rk4", (N, HIDDEN)), ("mlp_dopri5", (N, HIDDEN))]
    _build.build(specs)
    libs = {"new": {f: _build.load_library(f, s) for f, s in specs},
            "parent": {}}
    for tree in ("new", "parent"):
        for family, shape in specs:
            if tree == "new":
                log = _build.build_log(family, shape)
            else:
                libs[tree][family], log = build_other(csrc, family, shape)
            print(f"{tree}:")
            for name, regs, st, ld, smem in chip_smoke.ptxas_summary(
                    family, shape, log):
                threads = THREADS[tree].get(name)
                if threads:
                    warps = chip_smoke.warps_per_sm(regs, smem, threads)
                    print(f"    {name}: {warps} warps per SM ({threads} "
                          "threads a block)")
    print(f"builds: {time.perf_counter() - t0:.1f} s")

    # chip_smoke.py's construction of the inputs of phases 7 and 10
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
    stream = torch.cuda.current_stream(dev).cuda_stream

    def k7(lib):
        wbar = tuple(torch.empty_like(x) for x in w)
        lbar = torch.empty((N_CHAINS, N, 2), dtype=f32, device=dev)
        st = lib.mlp_rk4_bwd(*(x.data_ptr() for x in w), dts.data_ptr(),
                             ys.data_ptr(), g7.data_ptr(), N_CHAINS, T,
                             *(x.data_ptr() for x in wbar), lbar.data_ptr(),
                             stream)
        _build.check(st, "mlp_rk4_bwd")
        return wbar + (lbar,)

    def k3(lib, method):
        rec, nacc = recs[method]
        wbar = tuple(torch.empty_like(x) for x in w)
        lbar = torch.empty((N_CHAINS, N, 2), dtype=f32, device=dev)
        st = lib.mlp_dopri5_bwd(_build.TABLEAUS.index(method),
                                *(x.data_ptr() for x in w),
                                *(x.data_ptr() for x in wbar), ts.data_ptr(),
                                rec.data_ptr(), nacc.data_ptr(),
                                g3.data_ptr(), N_CHAINS, T, lbar.data_ptr(),
                                stream)
        _build.check(st, "mlp_dopri5_bwd")
        return wbar + (lbar,)

    x0c, f0c, dt0c = x0.contiguous(), f0.contiguous(), dt0.contiguous()

    def k6(lib):
        out = torch.empty_like(ys)
        st = lib.mlp_rk4_fwd(*(x.data_ptr() for x in w), x0c.data_ptr(),
                             dts.data_ptr(), N_CHAINS, T, out.data_ptr(),
                             stream)
        _build.check(st, "mlp_rk4_fwd")
        return (out,)

    def k2(lib):
        out = torch.empty_like(ys)
        nfe, nacc, nrej = (torch.empty(N_CHAINS, dtype=torch.int32,
                                       device=dev) for _ in range(3))
        t1 = torch.empty(N_CHAINS, dtype=f32, device=dev)
        rec = torch.empty((256, 2 * N + 2, N_CHAINS), dtype=f32, device=dev)
        st = lib.mlp_dopri5_fwd(1, 0, *(x.data_ptr() for x in w),
                                x0c.data_ptr(), f0c.data_ptr(),
                                dt0c.data_ptr(), ts.data_ptr(), N_CHAINS, T,
                                rtol, atol, 0.9, 10.0, 0.2, 100_000, 0, 256,
                                out.data_ptr(), nfe.data_ptr(),
                                nacc.data_ptr(), nrej.data_ptr(),
                                t1.data_ptr(), rec.data_ptr(), stream)
        _build.check(st, "mlp_dopri5_fwd")
        return out, nfe.float()

    kernels = {"K6": lambda t: k6(libs[t]["mlp_rk4"]),
               "MLP K2 DOPRI5": lambda t: k2(libs[t]["mlp_dopri5"]),
               "K7": lambda t: k7(libs[t]["mlp_rk4"]),
               "MLP K3 DOPRI5": lambda t: k3(libs[t]["mlp_dopri5"], "dopri5"),
               "MLP K3 TSIT5": lambda t: k3(libs[t]["mlp_dopri5"], "tsit5")}
    for label, run in kernels.items():
        a, b = run("new"), run("parent")
        torch.cuda.synchronize()
        if label.startswith("MLP K2"):
            # two float32 solves: their step meshes differ on some chains
            print(f"{label}: mean NFE this tree {float(a[1].mean()):.3f}, "
                  f"parent {float(b[1].mean()):.3f}")
            a, b = a[:1], b[:1]
        rel = max(chip_smoke.max_rel(x, y) for x, y in zip(a, b))
        ms = {"parent": [], "new": []}
        for tree in ("parent", "new", "new", "parent"):
            ms[tree].append(chip_smoke.cuda_ms(lambda: run(tree), 20,
                                               warmup=10))
        print(f"{label}: max-rel this tree vs parent {rel:.3e}; ms parent "
              f"{ms['parent'][0]:.3f} / {ms['parent'][1]:.3f}, this tree "
              f"{ms['new'][0]:.3f} / {ms['new'][1]:.3f}; speed-up "
              f"{sum(ms['parent']) / sum(ms['new']):.2f}x ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
