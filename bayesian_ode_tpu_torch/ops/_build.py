"""Build and load the hand-written CUDA kernels; count their launches.

The kernels under `csrc/` are compiled with nvcc into shared libraries
with a plain C interface and loaded with ctypes.  There is one library per
kernel family and shape, the shape baked in at compile time:

    "gp_dopri5"      K1-K3 over the GP field, keyed by (N trajectory
                     points, M inducing points)
    "mlp_dopri5"     K2/K3 over the MLP field, keyed by (N, H hidden units)
    "spiral_dopri5"  K2/K3 over the spiral field, keyed by (N, H)
    "fhn_dopri5"     K2/K3 over the FitzHugh-Nagumo field, keyed by (N,)
    "gp_rk4"         K4-K5, keyed by (N, M)
    "mlp_rk4"        K6-K7, keyed by (N, H)
    "gp_dopri5_step" K9, the per-step GP solver, keyed by (N, M)
    "svgd_phi"       K8, the SVGD direction, with no shape baked in

Each adaptive library holds both tableaus (DOPRI5 and TSIT5) and both
forwards (recording or not); its entry points take them as arguments.

A library is built at first use into `build/kernels/` beside the package
(git-ignored), named by a hash of its sources and flags, so a changed
source rebuilds and an unchanged one loads at once.  `build` compiles
several libraries together, one nvcc process per source, all started at
once.  Built for sm_90a (Hopper) without --use_fast_math: the solves need
full float32 `expf` and `tanhf`.

`launch_counts` holds one plain integer per kernel; each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.  The adaptive kernels count per field
and tableau: "{field}_{method}_solve_whole" (no records; K1 for the GP
field), "{field}_{method}_fwd_record" (K2) and "{field}_{method}_bwd" (K3).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Tuple

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Family(NamedTuple):
    sources: Tuple[str, ...]
    headers: Tuple[str, ...]
    defines: Tuple[str, ...]        # the shape macros
    dims: str                       # C entry point reporting the shape
    entry_points: Dict[str, list]   # C entry point -> argtypes (int result)


def _adaptive(field: str, headers: Tuple[str, ...], defines: Tuple[str, ...],
              n_w: int, n_s: int, n_wbar: int) -> Family:
    """The family of the fused adaptive kernels over one field: n_w weight
    pointers and n_s float scalars lead both entry points; the backward
    then takes the n_wbar cotangent outputs (dopri5_kernels.cuh)."""
    field_args = [_P] * n_w + [_F] * n_s
    return Family(
        (f"{field}_dopri5_fwd.cu", f"{field}_dopri5_bwd.cu"),
        ("dopri5_common.cuh", "dopri5_kernels.cuh", "field_stages.cuh")
        + headers, defines,
        f"{field}_dopri5_dims",
        {f"{field}_dopri5_fwd": [_I, _I] + field_args + [_P] * 4 + [_I] * 2
                                + [_F] * 5 + [_I] * 3 + [_P] * 6 + [_P],
         f"{field}_dopri5_bwd": [_I] + field_args + [_P] * n_wbar
                                + [_P] * 4 + [_I] * 2 + [_P] + [_P]})


FAMILIES: Dict[str, Family] = {
    "gp_dopri5": _adaptive("gp", ("gp_field.cuh", "warp.cuh"),
                           ("GP_N", "GP_M"), 2, 3, 1),
    "mlp_dopri5": _adaptive("mlp", ("mlp_field.cuh", "warp.cuh"),
                            ("MLP_N", "MLP_H"), 6, 0, 6),
    "spiral_dopri5": _adaptive("spiral", ("spiral_field.cuh", "warp.cuh"),
                               ("SPIRAL_N", "SPIRAL_H"), 4, 0, 4),
    "fhn_dopri5": _adaptive("fhn", ("fhn_field.cuh",), ("FHN_N",), 3, 0, 3),
    "gp_rk4": Family(
        ("gp_rk4.cu",),
        ("rk4_common.cuh", "field_stages.cuh", "gp_field.cuh", "warp.cuh"),
        ("GP_N", "GP_M"), "gp_rk4_dims",
        {"gp_rk4_fwd": [_P] * 4 + [_I, _I] + [_F] * 2 + [_P, _P],
         "gp_rk4_bwd": [_P] * 5 + [_I, _I] + [_F] * 3 + [_P] * 3}),
    "mlp_rk4": Family(
        ("mlp_rk4.cu",),
        ("rk4_common.cuh", "field_stages.cuh", "mlp_field.cuh", "warp.cuh"),
        ("MLP_N", "MLP_H"), "mlp_rk4_dims",
        {"mlp_rk4_fwd": [_P] * 8 + [_I, _I] + [_P, _P],
         "mlp_rk4_bwd": [_P] * 9 + [_I, _I] + [_P] * 8}),
    "gp_dopri5_step": Family(
        ("gp_dopri5_step.cu",),
        ("dopri5_common.cuh", "dopri5_kernels.cuh", "field_stages.cuh",
         "gp_field.cuh", "warp.cuh"),
        ("GP_N", "GP_M"), "gp_dopri5_step_dims",
        {"gp_dopri5_step": [_P] * 2 + [_F] * 3 + [_P] + [_I] * 4 + [_F] * 5
                           + [_P] * 10 + [_P]}),
    "svgd_phi": Family(
        ("svgd_phi.cu",), (), (), "svgd_phi_dims",
        {"svgd_phi": [_P] * 3 + [_I, _I] + [_P, _P]}),
}

ADAPTIVE_FIELDS = ("gp", "mlp", "spiral", "fhn")
TABLEAUS = ("dopri5", "tsit5")      # the entry points' tableau 0 and 1

# K1 is gp_dopri5_solve_whole, K2 "*_fwd_record", K3 "*_bwd"; K4/K5:
# gp_rk4_fwd/bwd; K6/K7: mlp_rk4_fwd/bwd; K8 svgd_phi; K9 gp_dopri5_step.
launch_counts: Dict[str, int] = {
    **{f"{field}_{method}_{kind}": 0 for field in ADAPTIVE_FIELDS
       for method in TABLEAUS
       for kind in ("solve_whole", "fwd_record", "bwd")},
    "gp_rk4_fwd": 0, "gp_rk4_bwd": 0, "mlp_rk4_fwd": 0, "mlp_rk4_bwd": 0,
    "svgd_phi": 0, "gp_dopri5_step": 0}

# loaded libraries by (family, shape); the sources do not change under a
# running process, so they are hashed once per library, not at every launch
_LIBS: Dict[Tuple[str, Tuple[int, ...]], ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built with the CUDA "
            "toolkit at first use on a machine with the card")
    return path


def _defines(family: str, shape: Tuple[int, ...]) -> Tuple[str, ...]:
    names = FAMILIES[family].defines
    if len(names) != len(shape):
        raise ValueError(f"{family} is keyed by {names}, got shape {shape}")
    return tuple(f"-D{n}={int(v)}" for n, v in zip(names, shape))


def library_path(family: str, shape: Tuple[int, ...]) -> Path:
    fam = FAMILIES[family]
    h = hashlib.sha256()
    for name in fam.sources + fam.headers:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS + _defines(family, shape)).encode())
    key = "_".join(f"{d[-1]}{v}" for d, v in zip(fam.defines, shape))
    return BUILD_DIR / f"{family}_{key}_{h.hexdigest()[:16]}.so"


def build_log(family: str, shape: Tuple[int, ...]) -> str:
    """nvcc's output for the library (ptxas registers, spills, shared
    memory per kernel); empty before the first build."""
    log = library_path(family, shape).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(specs: Iterable[Tuple[str, Tuple[int, ...]]]) -> None:
    """Build every library of `specs` ((family, shape) pairs) that is not
    built yet: one nvcc per source, all started together, then one link
    per library.  Raises with nvcc's output if any step fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for family, shape in dict.fromkeys((f, tuple(s)) for f, s in specs):
        so = library_path(family, shape)
        if so.exists():
            continue
        objs = []
        for src in FAMILIES[family].sources:
            obj = so.with_name(f"{so.stem}.{Path(src).stem}.{os.getpid()}.o")
            cmd = [_nvcc(), *NVCC_FLAGS, *_defines(family, shape),
                   f"-I{_CSRC}", "-c", str(_CSRC / src), "-o", str(obj)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            objs.append((obj, cmd, proc))
        jobs.append((so, objs))
    t0 = time.perf_counter()
    failed = []
    for so, objs in jobs:
        log = []
        for obj, cmd, proc in objs:
            out, _ = proc.communicate()
            log.append(f"# {' '.join(cmd)}\n# rc {proc.returncode}, "
                       f"{time.perf_counter() - t0:.1f} s\n{out}")
        if any(proc.returncode != 0 for _, _, proc in objs):
            failed.append(so.name)
        else:
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                   *(str(obj) for obj, _, _ in objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(f"# {' '.join(cmd)}\n# rc {proc.returncode}\n"
                       + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(so.name)
            else:
                os.replace(tmp, so)
        for obj, _, _ in objs:
            obj.unlink(missing_ok=True)
        so.with_suffix(".log").write_text("".join(log))
    if failed:
        logs = "\n".join(so.with_suffix(".log").read_text()
                         for so, _ in jobs)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")


def load_library(family: str, shape: Tuple[int, ...]) -> ctypes.CDLL:
    """The kernel library of `family` for this shape, built at first
    use."""
    shape = tuple(int(s) for s in shape)
    lib = _LIBS.get((family, shape))
    if lib is not None:
        return lib
    so = library_path(family, shape)
    if not so.exists():
        build([(family, shape)])
    lib = ctypes.CDLL(str(so))
    fam = FAMILIES[family]
    dims = getattr(lib, fam.dims)
    dims.argtypes = [ctypes.POINTER(_I)] * len(fam.defines)
    dims.restype = _I
    for name, argtypes in fam.entry_points.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    got = [_I() for _ in fam.defines]
    dims(*(ctypes.byref(v) for v in got))
    if tuple(v.value for v in got) != shape:
        raise RuntimeError(f"{so} was built for "
                           f"{tuple(v.value for v in got)}, not {shape}")
    _LIBS[(family, shape)] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
