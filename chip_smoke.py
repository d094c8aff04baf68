#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `bayesian_ode_tpu_torch/csrc/`, holds
each against its plain PyTorch version at the main path's full shape (Van
der Pol GP-ODE posterior: 5 trajectories, T=60 output times to t=6, a 6x6
inducing grid, 10,112 chains, dopri5 at rtol=1e-7 / atol=1e-9,
store_steps=128), then drives the main path through its public entry
point, `experiments.vanderpol_gp.run_sampler` (engine="fused",
solver="dopri5", model="gp"), for SGLD and pSGLD, and checks from the
launch counters that those runs went through the kernels.  Last, it times
steady-state SGLD and pSGLD steps through the same fused potential.

Exits non-zero on any failed phase, and when no CUDA device is available.
The line before the last is a JSON object with each kernel's launches,
error against its plain version and times; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

N_CHAINS = 10112
RTOL, ATOL = 1e-7, 1e-9
STORE_STEPS = 128


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps, warmup=0):
    """Mean milliseconds of fn() over `reps` calls, by CUDA events, after
    `warmup` untimed calls (the caller has already run fn once, so builds
    are excluded)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the GPU only",
              file=sys.stderr)
        return 2
    from bayesian_ode_tpu_torch import samplers
    from bayesian_ode_tpu_torch.experiments import run_sampler
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
        gp_dopri5_trajectory_plain,
        make_fused_gp_potential_dopri5,
    )
    from bayesian_ode_tpu_torch.samplers import schedules

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    kr.full_f32_matmul()

    # ---- build ----
    t0 = time.perf_counter()
    _build.load_library(5, 36)
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for line in _build.build_log(5, 36).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- inputs at the main path's shape ----
    data = make_dataset(seed=2, ode="vdp", N=5, T=60, t_max=6.0,
                        noise=0.05, x0_scale=1.5)
    static = kr.make_static(kr.make_inducing_grid(data["Y"], M=6), sf=1.0,
                            ell=0.75)
    U0 = kr.init_params(data["Y"], data["t"], static, noise=0.05)["U"]
    f32 = torch.float32
    s32 = kr.GPVectorFieldStatic(
        Z=static.Z.to(dev, f32), KzzinvL=static.KzzinvL.to(dev, f32),
        Kzzinv=static.Kzzinv.to(dev, f32), sf=static.sf, ell=static.ell)
    gen = torch.Generator(device=dev).manual_seed(0)
    U = U0.to(dev, f32)[None] + 3e-3 * torch.randn(
        (N_CHAINS, 36, 2), generator=gen, device=dev, dtype=f32)
    A = torch.einsum("mk,ckd->cmd", s32.KzzinvL, U).contiguous()
    x0 = data["x0"].to(dev, f32)
    ts = data["t"].to(dev, f32)
    Z = s32.Z.contiguous()
    # the kernels' own inputs (Hairer start step on the host), so that the
    # times below are of the kernels and their plain versions alone
    x0b, f0, dt0 = _pack_initial(A, x0, Z, s32.sf, s32.ell, RTOL, ATOL)
    args = (A, Z, x0b, f0, dt0, ts, s32.sf, s32.ell, RTOL, ATOL, 0.9, 10.0,
            0.2, 100_000, "i")
    kernels = {}

    # ---- phase 1: K1 against its plain version ----
    ys_k, st_k = gp_dopri5_solve_whole(A, x0, ts, s32, rtol=RTOL, atol=ATOL)
    ys_p, st_p = gp_dopri5_solve_whole_plain(A, x0, ts, s32, rtol=RTOL,
                                             atol=ATOL)
    torch.cuda.synchronize()
    scale = float(ys_p.abs().max())
    err1 = float((ys_k - ys_p).abs().max())
    nfe_k = float(st_k["nfe"].float().mean())
    nfe_p = float(st_p["nfe"].float().mean())
    print(f"K1: max|ys - plain| = {err1:.3e} (max|y| {scale:.4f}), "
          f"mean NFE {nfe_k:.3f} vs plain {nfe_p:.3f}, mean accepted "
          f"{float(st_k['n_accepted'].float().mean()):.3f}, rejected "
          f"{float(st_k['n_rejected'].float().mean()):.3f}")
    check(bool(torch.isfinite(ys_k).all()), "K1 trajectories finite")
    check(err1 <= 1e-4 * scale, "K1 within 1e-4 max|y| of plain")
    check(abs(nfe_k - nfe_p) <= 0.01 * nfe_p, "K1 mean NFE within 1%")
    check(st_k["reached_final_time"], "K1 reaches t_final on every chain")
    ms1 = cuda_ms(lambda: fa._launch_fwd(*args, record=False,
                                         store_steps=0), 20, warmup=10)
    ms1p = cuda_ms(lambda: fa.fwd_plain(*args), 1)
    print(f"K1: {ms1:.3f} ms/solve of {N_CHAINS} chains "
          f"({N_CHAINS / ms1 * 1e3:.0f} solves/s), plain {ms1p:.1f} ms")
    kernels["gp_dopri5_solve_whole"] = dict(
        source="bayesian_ode_tpu_torch/csrc/gp_dopri5_fwd.cu",
        replaces="bayesian_ode_tpu/ops/gp_dopri5.py:302",
        max_abs_err=err1, ms=ms1, plain_ms=ms1p)

    # ---- phase 2: K2 (recording forward) and K3 (replay backward) ----
    ys2, _, nacc, _, _, rec = fa.fwd(*args, record=True,
                                     store_steps=STORE_STEPS)
    ys2p, _, nacc_p, _, _, rec_p = fa.fwd_plain(*args,
                                                store_steps=STORE_STEPS)
    torch.cuda.synchronize()
    check(torch.equal(ys2, ys_k), "K2 trajectories bit-equal to K1's")
    worst = int(nacc.max())
    err2 = float((ys2 - ys2p).abs().max())
    print(f"K2: trajectories equal K1's bit for bit; largest record count "
          f"{worst}/{STORE_STEPS}; max|ys - plain| = {err2:.3e}")
    check(worst <= STORE_STEPS, "record count within store_steps")
    ms2 = cuda_ms(lambda: fa._launch_fwd(*args, record=True,
                                         store_steps=STORE_STEPS), 20,
                  warmup=10)
    ms2p = cuda_ms(lambda: fa.fwd_plain(*args, store_steps=STORE_STEPS), 1)
    print(f"K2: {ms2:.3f} ms, plain {ms2p:.1f} ms")
    kernels["gp_dopri5_fwd_record"] = dict(
        source="bayesian_ode_tpu_torch/csrc/gp_dopri5_fwd.cu",
        replaces="bayesian_ode_tpu/ops/fused_adaptive.py:58",
        max_abs_err=err2, ms=ms2, plain_ms=ms2p)

    gen_g = torch.Generator(device=dev).manual_seed(5)
    g = torch.randn(ys2.shape, generator=gen_g, device=dev, dtype=f32)
    Abar_k, lbar_k = fa.bwd(A, Z, ts, rec, nacc, g, s32.sf, s32.ell)
    Abar_p, _ = fa.bwd_plain(A, Z, ts, rec_p, nacc_p, g, s32.sf, s32.ell)
    A_req = A.clone().requires_grad_(True)
    ys_ag = gp_dopri5_trajectory_plain(A_req, x0, ts, s32, rtol=RTOL,
                                       atol=ATOL)
    (Abar_ag,) = torch.autograd.grad((ys_ag * g).sum(), [A_req])
    del ys_ag
    torch.cuda.synchronize()
    check(bool(torch.isfinite(Abar_k).all()), "K3 cotangents finite")
    rel_p = float((Abar_k - Abar_p).abs().max() / Abar_p.abs().max())
    rel_ag = float((Abar_k - Abar_ag).abs().max() / Abar_ag.abs().max())
    print(f"K3: Abar max-rel {rel_p:.3e} vs plain replay, {rel_ag:.3e} vs "
          "autograd through the plain forward")
    check(rel_p <= 1e-3, "K3 within 1e-3 max-rel of the plain replay")
    check(rel_ag <= 1e-3, "K3 within 1e-3 max-rel of autograd")
    ms3 = cuda_ms(lambda: fa.bwd(A, Z, ts, rec, nacc, g, s32.sf, s32.ell),
                  20, warmup=10)
    ms3p = cuda_ms(lambda: fa.bwd_plain(A, Z, ts, rec_p, nacc_p, g, s32.sf,
                                        s32.ell), 1)
    print(f"K3: {ms3:.3f} ms, plain replay {ms3p:.1f} ms")
    kernels["gp_dopri5_bwd"] = dict(
        source="bayesian_ode_tpu_torch/csrc/gp_dopri5_bwd.cu",
        replaces="bayesian_ode_tpu/ops/fused_adaptive.py:180",
        max_abs_err=float((Abar_k - Abar_p).abs().max()), ms=ms3,
        plain_ms=ms3p)
    del rec_p, Abar_p, Abar_ag

    # ---- phases 3 and 4: the experiment driver, SGLD then pSGLD ----
    cfg = {"method": "SGLD", "inf_type": "sampler", "id": 1, "M": 6,
           "sf": 1.0, "ell": 0.75, "noise": 0.05, "burn_in": 5,
           "num_samples": 20, "thinning": 1, "num_chains": N_CHAINS,
           "lr0": 1e-5, "lr_gamma": 0.55, "lr_t0": 100, "lr_alpha": 1.0,
           "psgld_alpha": 0.99, "lambda_": 1e-8, "engine": "fused",
           "solver": "dopri5", "model": "gp", "rtol": RTOL, "atol": ATOL,
           "store_steps": STORE_STEPS, "seed": 0}
    runs = [("SGLD", 5, 20), ("pSGLD", 0, 5)]
    with tempfile.TemporaryDirectory() as out:
        _build.reset_launch_counts()
        for method, burn_in, samples in runs:
            before = dict(_build.launch_counts)
            c = dict(cfg, method=method, burn_in=burn_in,
                     num_samples=samples)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = run_sampler(c, data, out, make_plots=False,
                                  device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps = burn_in + samples
            delta = {k: v - before[k]
                     for k, v in _build.launch_counts.items()}
            rate = steps * summary["num_chains"] / wall
            print(f"{method}: {steps} steps x {summary['num_chains']} chains "
                  f"in {wall:.3f} s = {rate:.0f} chain-steps/s (set-up and "
                  f"probe included); launches {delta}")
            print(f"{method}: summary {json.dumps(summary)}")
            check(delta["gp_dopri5_fwd_record"] == steps + 1,
                  f"{method}: K2 launched once per step plus init")
            check(delta["gp_dopri5_bwd"] == steps + 1,
                  f"{method}: K3 launched once per step plus init")
            check(delta["gp_dopri5_solve_whole"] == 1,
                  f"{method}: K1 launched once (store_steps probe)")
            pots = np.load(os.path.join(out, method, "1",
                                        "total_loss_arr.npy"))
            check(pots.shape == (N_CHAINS, samples), f"{method} pots shape")
            check(bool(np.isfinite(pots).all()), f"{method}: finite "
                  "potentials")
        counts = dict(_build.launch_counts)
    for name, k in kernels.items():
        check(counts[name] > 0, f"{name} launched by the main path")

    # ---- phase 5: steady-state sampler steps (no set-up, probe or I/O) ----
    pot = make_fused_gp_potential_dopri5(s32, x0, ts, data["Y"].to(dev, f32),
                                         rtol=RTOL, atol=ATOL,
                                         store_steps=STORE_STEPS)
    sched = schedules.polynomial_decay(lr0=1e-5, gamma=0.55, t0=100)
    pos = {"U": U, "logsn": torch.full((N_CHAINS, 2), float(np.log(0.05)),
                                       device=dev)}
    for method, kern in (
            ("SGLD", samplers.sgld_batched(pot, sched)),
            ("pSGLD", samplers.psgld_batched(pot, sched, alpha=0.99,
                                             lambda_=1e-8))):
        gen = torch.Generator(device=dev).manual_seed(1)
        state = kern.init(pos)
        for _ in range(2):
            state, _ = kern.step(gen, state)
        steps = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = kern.step(gen, state)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        check(bool(torch.isfinite(state.potential).all()),
              f"{method}: finite potentials in the steady run")
        print(f"{method} steady: {ms:.3f} ms/step over {steps} steps = "
              f"{N_CHAINS / ms * 1e3:.0f} chain-steps/s")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": counts[name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"]} for name, k in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
