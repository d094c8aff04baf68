"""Build and load the hand-written CUDA kernels; count their launches.

The kernels under `csrc/` are compiled with nvcc into shared libraries
with a plain C interface and loaded with ctypes.  There is one library per
kernel family and shape, the shape baked in at compile time:

    "gp_dopri5"  K1-K3, keyed by (N trajectory points, M inducing points)
    "gp_rk4"     K4-K5, keyed by (N, M)
    "mlp_rk4"    K6-K7, keyed by (N, H hidden units)

A library is built at first use into `build/kernels/` beside the package
(git-ignored), named by a hash of its sources and flags, so a changed
source rebuilds and an unchanged one loads at once.  `build` compiles
several libraries together, one nvcc process per source, all started at
once.  Built for sm_90a (Hopper) without --use_fast_math: the solves need
full float32 `expf`.

`launch_counts` holds one plain integer per kernel; each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
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
    defines: Tuple[str, str]        # the two shape macros
    dims: str                       # C entry point reporting the shape
    entry_points: Dict[str, list]   # C entry point -> argtypes (int result)


FAMILIES: Dict[str, Family] = {
    "gp_dopri5": Family(
        ("gp_dopri5_fwd.cu", "gp_dopri5_bwd.cu"),
        ("dopri5_common.cuh", "gp_field.cuh"), ("GP_N", "GP_M"),
        "gp_dopri5_dims",
        {"gp_dopri5_fwd": [_I] + [_P] * 6 + [_I, _I] + [_F] * 7
                          + [_I, _I, _I] + [_P] * 6 + [_P],
         "gp_dopri5_bwd": [_P] * 6 + [_I, _I] + [_F] * 3 + [_P, _P, _P]}),
    "gp_rk4": Family(
        ("gp_rk4.cu",), ("rk4_common.cuh", "gp_field.cuh"), ("GP_N", "GP_M"),
        "gp_rk4_dims",
        {"gp_rk4_fwd": [_P] * 4 + [_I, _I] + [_F] * 2 + [_P, _P],
         "gp_rk4_bwd": [_P] * 5 + [_I, _I] + [_F] * 3 + [_P] * 3}),
    "mlp_rk4": Family(
        ("mlp_rk4.cu",), ("rk4_common.cuh", "mlp_field.cuh"),
        ("MLP_N", "MLP_H"), "mlp_rk4_dims",
        {"mlp_rk4_fwd": [_P] * 8 + [_I, _I] + [_P, _P],
         "mlp_rk4_bwd": [_P] * 9 + [_I, _I] + [_P] * 8}),
}

# K1: the whole solve (gp_dopri5_fwd, record=0); K2: the recording forward
# (gp_dopri5_fwd, record=1); K3: the replay backward (gp_dopri5_bwd);
# K4/K5: gp_rk4_fwd/bwd; K6/K7: mlp_rk4_fwd/bwd.
launch_counts: Dict[str, int] = {"gp_dopri5_solve_whole": 0,
                                 "gp_dopri5_fwd_record": 0,
                                 "gp_dopri5_bwd": 0,
                                 "gp_rk4_fwd": 0, "gp_rk4_bwd": 0,
                                 "mlp_rk4_fwd": 0, "mlp_rk4_bwd": 0}

# loaded libraries by (family, shape); the sources do not change under a
# running process, so they are hashed once per library, not at every launch
_LIBS: Dict[Tuple[str, Tuple[int, int]], ctypes.CDLL] = {}


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


def _defines(family: str, shape: Tuple[int, int]) -> Tuple[str, str]:
    names = FAMILIES[family].defines
    return tuple(f"-D{n}={int(v)}" for n, v in zip(names, shape))


def library_path(family: str, shape: Tuple[int, int]) -> Path:
    fam = FAMILIES[family]
    h = hashlib.sha256()
    for name in fam.sources + fam.headers:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS + _defines(family, shape)).encode())
    return BUILD_DIR / (f"{family}_{fam.defines[0][-1]}{shape[0]}_"
                        f"{fam.defines[1][-1]}{shape[1]}_"
                        f"{h.hexdigest()[:16]}.so")


def build_log(family: str, shape: Tuple[int, int]) -> str:
    """nvcc's output for the library (ptxas registers, spills, shared
    memory per kernel); empty before the first build."""
    log = library_path(family, shape).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(specs: Iterable[Tuple[str, Tuple[int, int]]]) -> None:
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


def load_library(family: str, shape: Tuple[int, int]) -> ctypes.CDLL:
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
    dims.argtypes = [ctypes.POINTER(_I), ctypes.POINTER(_I)]
    dims.restype = _I
    for name, argtypes in fam.entry_points.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    a, b = _I(), _I()
    dims(ctypes.byref(a), ctypes.byref(b))
    if (a.value, b.value) != shape:
        raise RuntimeError(f"{so} was built for {(a.value, b.value)}, "
                           f"not {shape}")
    _LIBS[(family, shape)] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
