"""Build and load the hand-written CUDA kernels; count their launches.

The kernels under `csrc/` are compiled with nvcc into a shared library
with a plain C interface and loaded with ctypes.  A library is built at
first use, for one (N trajectory points, M inducing points) shape baked in
at compile time, into `build/kernels/` beside the package (git-ignored),
keyed by a hash of the sources and flags, so a changed source rebuilds and
an unchanged one loads at once.  Built for sm_90a (Hopper) without
--use_fast_math: the adaptive solves need full float32 `expf`.

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
from typing import Dict, Tuple

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("gp_dopri5_fwd.cu", "gp_dopri5_bwd.cu")
HEADERS = ("dopri5_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# K1: the whole solve (gp_dopri5_fwd, record=0); K2: the recording forward
# (gp_dopri5_fwd, record=1); K3: the replay backward (gp_dopri5_bwd).
launch_counts: Dict[str, int] = {"gp_dopri5_solve_whole": 0,
                                 "gp_dopri5_fwd_record": 0,
                                 "gp_dopri5_bwd": 0}

# loaded libraries by (N, M); the sources do not change under a running
# process, so they are hashed once per shape, not at every launch
_LIBS: Dict[Tuple[int, int], ctypes.CDLL] = {}


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


def library_path(n_points: int, n_inducing: int) -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    defines = (f"-DGP_N={n_points}", f"-DGP_M={n_inducing}")
    h.update(" ".join(NVCC_FLAGS + defines).encode())
    return BUILD_DIR / f"gp_dopri5_N{n_points}_M{n_inducing}_" \
                       f"{h.hexdigest()[:16]}.so"


def build_log(n_points: int, n_inducing: int) -> str:
    """nvcc's output for the library (ptxas registers, spills, shared
    memory per kernel); empty before the first build."""
    log = library_path(n_points, n_inducing).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _build(so: Path, n_points: int, n_inducing: int) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, f"-DGP_N={n_points}",
           f"-DGP_M={n_inducing}", f"-I{_CSRC}", "-o", str(tmp),
           *(str(_CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (f"# {' '.join(cmd)}\n# {time.perf_counter() - t0:.1f} s\n"
           + proc.stdout + proc.stderr)
    so.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, so)


def load_library(n_points: int, n_inducing: int) -> ctypes.CDLL:
    """The kernel library for this shape, built at first use."""
    lib = _LIBS.get((n_points, n_inducing))
    if lib is not None:
        return lib
    so = library_path(n_points, n_inducing)
    if not so.exists():
        _build(so, n_points, n_inducing)
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gp_dopri5_dims.argtypes = [ctypes.POINTER(I), ctypes.POINTER(I)]
    lib.gp_dopri5_dims.restype = I
    lib.gp_dopri5_fwd.argtypes = ([I] + [P] * 6 + [I, I] + [F] * 7
                                  + [I, I, I] + [P] * 6 + [P])
    lib.gp_dopri5_fwd.restype = I
    lib.gp_dopri5_bwd.argtypes = [P] * 6 + [I, I] + [F] * 3 + [P, P, P]
    lib.gp_dopri5_bwd.restype = I
    n, m = I(), I()
    lib.gp_dopri5_dims(ctypes.byref(n), ctypes.byref(m))
    if (n.value, m.value) != (n_points, n_inducing):
        raise RuntimeError(f"{so} was built for N={n.value}, M={m.value}")
    _LIBS[(n_points, n_inducing)] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
