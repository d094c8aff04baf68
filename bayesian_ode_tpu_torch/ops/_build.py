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
    "gp_dopri5_step" K9, the per-step GP solver's output intervals, keyed
                     by (N, M)
    "svgd_phi"       K8, the SVGD direction, with no shape baked in

Each adaptive library holds both tableaus (DOPRI5 and TSIT5) and both
forwards (recording or not); its entry points take them as arguments.

`check_shape` refuses, before any build, a shape the kernels cannot take,
with a NotImplementedError that names ROADMAP queue 1 item 19 and the
limit: more trajectory points than the kernels spread (`MAX_POINTS`:
N <= 128 for the GP field's one point a thread over up to 4 warps a chain,
N <= 32 for the MLP field's one component or one point a lane, N <= 64
for the spiral field's up to 4 components a lane), more inducing points
than M <= 1,024 (`GP_MAX_INDUCING`), an MLP wider than its lanes' units
(`mlp_max_hidden`: H <= 128 at N <= 16, H <= 64 at N <= 32), a spiral
wider than H <= 256 (`SPIRAL_MAX_HIDDEN`), or a block's shared memory
past its limit, by the arithmetic of the kernels' structs (`smem_bytes`):
48 KB for the buffers a kernel keeps in static shared memory, 232,448 B
(an sm_90 block's opt-in maximum) for the dynamic ones (`dynamic_smem`:
the GP field's, the MLP field's past H = 32 or N = 16, the spiral's past
N = 16 or 48 KB).  Each library reports what its build allocated through
its `*_smem` entry points (`built_smem`), which the card tests hold to
that arithmetic.

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
from concurrent.futures import ThreadPoolExecutor
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
    # C entry point reporting its kernels' shared-memory bytes -> the kind
    # of each kernel it reports, in its order (keys of smem_bytes)
    smem: Dict[str, Tuple[str, ...]]


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
                                + [_P] * 4 + [_I] * 2 + [_P] + [_P],
         f"{field}_dopri5_fwd_smem": [_P],
         f"{field}_dopri5_bwd_smem": [_P]},
        # (DOPRI5, TSIT5) x (no records, records); DOPRI5, TSIT5
        {f"{field}_dopri5_fwd_smem": ("fwd",) * 4,
         f"{field}_dopri5_bwd_smem": ("bwd",) * 2})


FAMILIES: Dict[str, Family] = {
    "gp_dopri5": _adaptive("gp", ("gp_field.cuh", "gp_wide_field.cuh",
                                  "warp.cuh"),
                           ("GP_N", "GP_M"), 2, 3, 1),
    "mlp_dopri5": _adaptive("mlp", ("mlp_field.cuh", "mlp_wide_field.cuh",
                                    "warp.cuh"),
                            ("MLP_N", "MLP_H"), 6, 0, 6),
    "spiral_dopri5": _adaptive("spiral", ("spiral_field.cuh",
                                          "spiral_wide_field.cuh",
                                          "warp.cuh"),
                               ("SPIRAL_N", "SPIRAL_H"), 4, 0, 4),
    "fhn_dopri5": _adaptive("fhn", ("fhn_field.cuh", "warp.cuh"), ("FHN_N",),
                            3, 0, 3),
    "gp_rk4": Family(
        ("gp_rk4.cu",),
        ("rk4_common.cuh", "field_stages.cuh", "gp_field.cuh",
         "gp_wide_field.cuh", "warp.cuh"),
        ("GP_N", "GP_M"), "gp_rk4_dims",
        {"gp_rk4_fwd": [_P] * 4 + [_I, _I] + [_F] * 2 + [_P, _P],
         "gp_rk4_bwd": [_P] * 5 + [_I, _I] + [_F] * 3 + [_P] * 3,
         "gp_rk4_smem": [_P]},
        {"gp_rk4_smem": ("fwd", "bwd")}),
    "mlp_rk4": Family(
        ("mlp_rk4.cu",),
        ("rk4_common.cuh", "field_stages.cuh", "mlp_field.cuh",
         "mlp_wide_field.cuh", "warp.cuh"),
        ("MLP_N", "MLP_H"), "mlp_rk4_dims",
        {"mlp_rk4_fwd": [_P] * 8 + [_I, _I] + [_P, _P],
         "mlp_rk4_bwd": [_P] * 9 + [_I, _I] + [_P] * 8,
         "mlp_rk4_smem": [_P]},
        {"mlp_rk4_smem": ("fwd", "bwd")}),
    "gp_dopri5_step": Family(
        ("gp_dopri5_step.cu",),
        ("dopri5_common.cuh", "dopri5_kernels.cuh", "field_stages.cuh",
         "gp_field.cuh", "gp_wide_field.cuh", "warp.cuh"),
        ("GP_N", "GP_M"), "gp_dopri5_step_dims",
        {"gp_dopri5_interval": [_P] * 2 + [_F] * 3 + [_P] + [_I] * 3
                               + [_F] * 5 + [_P] * 11 + [_P],
         "gp_dopri5_intervals": [_P] * 2 + [_F] * 3 + [_P] + [_I] * 4
                                + [_F] * 5 + [_P] * 11 + [_P],
         "gp_dopri5_step_smem": [_P]},
        {"gp_dopri5_step_smem": ("step",)}),
    "svgd_phi": Family(
        ("svgd_phi.cu",), (), (), "svgd_phi_dims",
        {"svgd_phi": [_P] * 3 + [_I] * 3 + [_P] * 3,
         "svgd_phi_splits": [_I, _I, _P],
         "svgd_phi_smem": [_P]},
        # the 32-, 64- and 96-feature chunk instances, then the combine
        {"svgd_phi_smem": ("phi",) * 3 + ("combine",)}),
}

# The shape limits of check_shape (csrc/: one GP trajectory point a
# thread, a chain over up to 4 warps past N = 32, gp_field.cuh and
# gp_wide_field.cuh; one MLP state component a lane to N = 16 and one point
# a lane past it, mlp_field.cuh and mlp_wide_field.cuh; one spiral state
# component a lane to N = 16 and up to 4 past it, spiral_field.cuh and
# spiral_wide_field.cuh), and the shared memory a block may have: 48 KB
# static, 232,448 B dynamic on sm_90 (the build's only target).
GP_FAMILIES = ("gp_dopri5", "gp_rk4", "gp_dopri5_step")
MAX_POINTS = {"gp_dopri5": 128, "gp_rk4": 128, "gp_dopri5_step": 128,
              "mlp_dopri5": 32, "mlp_rk4": 32, "spiral_dopri5": 64}
GP_MAX_INDUCING = 1024
SPIRAL_MAX_HIDDEN = 256
STATIC_SMEM_MAX = 48 * 1024
DYNAMIC_SMEM_MAX = 232_448
ITEM_19 = "ROADMAP queue 1 item 19"


def mlp_max_hidden(n_points: int) -> int:
    """The MLP kernels' widest field at N points: four hidden units a lane
    to N = 16, two past it (csrc/mlp_wide_field.cuh)."""
    return 128 if n_points <= 16 else 64


def mlp_wide(shape: Tuple[int, ...]) -> bool:
    """Whether an MLP library of shape (N, H) is built on
    csrc/mlp_wide_field.cuh (past H = 32 or N = 16) rather than
    mlp_field.cuh's one unit and one component a lane."""
    N, H = shape
    return H > 32 or N > 16


def _spiral_buf(N: int, H: int) -> int:
    """The bytes of one warp's SpiralBuf<7> (csrc/spiral_field.cuh): 7
    stage points and a cotangent of 2N floats padded to 4, and each stage
    point's tanh values, N x ceil(H/32) x 32 floats (a multiple of 16 B)."""
    return 4 * (8 * _round_up(2 * N, 4) + 7 * N * -(-H // 32) * 32)


def spiral_wide(shape: Tuple[int, ...]) -> bool:
    """Whether a spiral library of shape (N, H) is built on
    csrc/spiral_wide_field.cuh (past N = 16, or where one warp's SpiralBuf<7>
    passes 48 KB: BODE_SPIRAL_WIDE) rather than spiral_field.cuh's one
    component a lane."""
    N, H = shape
    return N > 16 or _spiral_buf(N, H) > STATIC_SMEM_MAX


class GPBlock(NamedTuple):
    """A GP kernel's block (csrc/gp_field.cuh, gp_wide_field.cuh): its
    threads and chains, whether it is GPWidePoint's, and its dynamic
    shared-memory bytes."""
    threads: int
    chains: int
    wide: bool
    smem: int


def gp_block(shape: Tuple[int, ...], R: int, acc: bool) -> GPBlock:
    """The block of the GP kernel on GPPoint<R> (with the Abar columns of a
    sweep where `acc`) at (N, M), or on GPWidePoint where that block passes
    N = 32 or DYNAMIC_SMEM_MAX (gp_field.cuh's gp_narrow): 8 B an inducing
    point a chain for A, 8 B one for Z; GPPoint's sweeps 1,024 B one past R
    for its threads' Abar columns, GPWidePoint's 8 B one a chain (past
    N = 32 one a warp), and 8 B a point for the error norm past N = 32."""
    N, M = shape
    if N <= 32:
        chains = 4 * (32 // N)
        kR = min(R, M)
        narrow = 8 * (M * chains + M) + (
            8 * ((M - kR) * 128 + (kR == M)) if acc else 0)
        if narrow <= DYNAMIC_SMEM_MAX:
            return GPBlock(128, chains, False, narrow)
    warps_a_chain = -(-N // 32)
    if warps_a_chain > 1:
        warps, chains, segs = warps_a_chain, 1, warps_a_chain
    else:
        per_warp = min(32 // N, (DYNAMIC_SMEM_MAX - 8 * M) // (16 * M))
        warps = 4
        while warps > 1 and 16 * M * per_warp * warps + 8 * M \
                > DYNAMIC_SMEM_MAX:
            warps //= 2
        chains = segs = warps * per_warp
    sm = 8 * (M * chains + M + (N if warps_a_chain > 1 else 1))
    return GPBlock(32 * warps, chains, True,
                   sm + (8 * M * segs if acc else 0))


def dynamic_smem(family: str, shape: Tuple[int, ...]) -> bool:
    """Whether the library's kernels keep their buffers in dynamic shared
    memory: the GP field's at every shape (kDynamicSmem), the MLP field's
    past H = 32 or N = 16 (mlp_wide), the spiral's past N = 16 or 48 KB
    (spiral_wide)."""
    return (family in GP_FAMILIES
            or (family.startswith("mlp") and mlp_wide(shape))
            or (family == "spiral_dopri5" and spiral_wide(shape)))


def _round_up(n: int, a: int) -> int:
    return -(-n // a) * a


def _warps_fitting(most: int, nbytes: int) -> int:
    """csrc/warp.cuh warps_fitting: the most warps a block, `most` or a
    half or quarter of it, whose buffers fit 48 KB of static shared
    memory."""
    while most > 1 and most * nbytes > STATIC_SMEM_MAX:
        most //= 2
    return most


def smem_bytes(family: str, shape: Tuple[int, ...]) -> Dict[str, int]:
    """Shared-memory bytes a block of each kernel of the library takes, by
    kind ("fwd", "bwd", "step", "phi", "combine"), by the arithmetic of the structs in
    csrc/ (sizeof of arrays of float and float2; MLPBuf, MLPFwdBuf,
    SpiralBuf and SpiralFwdBuf aligned to 16 B)."""
    f4 = 4
    if family in GP_FAMILIES:
        # GPFwdPoint (K1, K2, K4, K9), GPReplayPoint (K3), GPRk4Point (K5)
        fwd = gp_block(shape, 8, False).smem
        if family == "gp_dopri5_step":
            return {"step": fwd}
        R = 8 if family == "gp_dopri5" else 12
        return {"fwd": fwd, "bwd": gp_block(shape, R, True).smem}
    if family in ("mlp_rk4", "mlp_dopri5"):
        N, H = shape
        h4 = _round_up(H, 4)
        vec = _round_up(2 * N, 4)
        slots = 4 if family == "mlp_rk4" else 7
        if mlp_wide(shape):
            # mlp_wide_field.cuh, one warp a block: W2's rows of kHU + 4
            # floats and the h1 copy (MLPWideFwdBuf, MLPWideBuf), the
            # slots' a2 and points and the cotangent, W2bar after them
            hu = 32 * -(-H // 32)
            rows_h1 = h4 * (hu + 4) + N * hu
            fwd = _round_up(f4 * (rows_h1 + vec), 16)
            bwd = _round_up(f4 * (rows_h1 + slots * (N * hu + vec) + vec),
                            16) + f4 * h4 * hu
            return {"fwd": fwd, "bwd": bwd}
        row = h4 if (h4 // 4) % 2 else h4 + 4
        fwd_buf = _round_up(f4 * (N * 32 + vec), 16)            # MLPFwdBuf

        def buf(slots):                                         # MLPBuf
            return _round_up(f4 * (2 * slots * N * 32 + H * row
                                   + slots * vec + vec), 16)

        most = 4 if family == "mlp_rk4" else 2
        return {"fwd": 4 * fwd_buf,
                "bwd": _warps_fitting(most, buf(slots)) * buf(slots)}
    if family == "spiral_dopri5":
        # the forward's warps each gather the point (SpiralFwdBuf); the
        # backward's keep 7 stage slots and a cotangent (SpiralBuf<7>): 4
        # warps a block, or fewer to fit 48 KB; past N = 16 or 48 KB one
        # warp, dynamic (spiral_wide_field.cuh)
        N, H = shape
        fwd, buf = _round_up(f4 * _round_up(2 * N, 4), 16), _spiral_buf(N, H)
        if spiral_wide(shape):
            return {"fwd": fwd, "bwd": buf}
        return {"fwd": 4 * fwd, "bwd": _warps_fitting(4, buf) * buf}
    if family == "fhn_dopri5":
        # theta in registers and the error norm by shuffles: no buffers
        return {"fwd": 0, "bwd": 0}
    if family == "svgd_phi":
        # PhiSmem (static, one size for every chunk width): the rows'
        # features (96 x 36), the columns' particles (32 x 97) and scores
        # (32 x 96), the K tile (32 x 36), the norms (32 + 32); the combine
        # has none
        return {"phi": f4 * (96 * 36 + 32 * 97 + 32 * 96 + 32 * 36 + 64),
                "combine": 0}
    raise ValueError(f"unknown kernel family {family!r}")


def check_shape(family: str, shape: Tuple[int, ...]) -> None:
    """Raise NotImplementedError, naming ROADMAP queue 1 item 19 and the
    limit, for a shape the family's kernels cannot compile; before any
    build, so nvcc never sees it."""
    if family not in FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}")
    shape = tuple(int(s) for s in shape)
    _defines(family, shape)                     # the key's length
    if any(s < 1 for s in shape):
        raise ValueError(f"{family}: shape {shape} must be positive")
    if family in MAX_POINTS and shape[0] > MAX_POINTS[family]:
        what = ("one trajectory point a thread, a chain over at most 4 "
                "warps" if family in GP_FAMILIES
                else "at most one trajectory point a lane"
                if family.startswith("mlp")
                else "at most 4 state components a lane")
        raise NotImplementedError(
            f"{family} at N={shape[0]}: the kernels hold {what}, N <= "
            f"{MAX_POINTS[family]} ({ITEM_19})")
    if family in GP_FAMILIES and shape[1] > GP_MAX_INDUCING:
        raise NotImplementedError(
            f"{family} at M={shape[1]} inducing points: the kernels take "
            f"M <= {GP_MAX_INDUCING}, a 32 x 32 grid ({ITEM_19})")
    if family == "spiral_dopri5" and shape[1] > SPIRAL_MAX_HIDDEN:
        raise NotImplementedError(
            f"spiral hidden width {shape[1]}: the kernels hold at most "
            f"{SPIRAL_MAX_HIDDEN // 32} hidden units a lane, H <= "
            f"{SPIRAL_MAX_HIDDEN} ({ITEM_19})")
    if family.startswith("mlp") and shape[1] > mlp_max_hidden(shape[0]):
        most = mlp_max_hidden(shape[0])
        raise NotImplementedError(
            f"hidden width {shape[1]} at N={shape[0]}: the MLP kernels hold "
            f"at most {most // 32} hidden units a lane there, H <= {most} "
            f"({ITEM_19})")
    dynamic = dynamic_smem(family, shape)
    limit = DYNAMIC_SMEM_MAX if dynamic else STATIC_SMEM_MAX
    for kind, nbytes in smem_bytes(family, shape).items():
        if nbytes > limit:
            raise NotImplementedError(
                f"{family} at {shape}: a block of its {kind} kernel needs "
                f"{nbytes} B of {'dynamic' if dynamic else 'static'} shared "
                f"memory, past the {limit} B a block may have ({ITEM_19})")

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
    per library.  Raises check_shape's error for a shape the kernels
    cannot take, before any nvcc, and with nvcc's output if any step
    fails."""
    specs = list(dict.fromkeys((f, tuple(int(v) for v in s))
                               for f, s in specs))
    for family, shape in specs:
        check_shape(family, shape)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for family, shape in specs:
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

    def finish(proc):
        out, _ = proc.communicate()
        return out, time.perf_counter() - t0

    # each nvcc's output read as it ends, so that its log has its own
    # seconds from the wave's start
    n_procs = sum(len(objs) for _, objs in jobs)
    with ThreadPoolExecutor(max_workers=max(1, n_procs)) as pool:
        ended = [[pool.submit(finish, proc) for _, _, proc in objs]
                 for _, objs in jobs]
    failed = []
    for (so, objs), outs in zip(jobs, ended):
        log = []
        for (obj, cmd, proc), done in zip(objs, outs):
            out, sec = done.result()
            log.append(f"# {' '.join(cmd)}\n# rc {proc.returncode}, "
                       f"{sec:.1f} s\n{out}")
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
    """The kernel library of `family` for this shape, built at first use;
    a shape the kernels cannot take raises check_shape's
    NotImplementedError first."""
    shape = tuple(int(s) for s in shape)
    lib = _LIBS.get((family, shape))
    if lib is not None:
        return lib
    check_shape(family, shape)
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


def built_smem(family: str, shape: Tuple[int, ...]) -> Dict[str, list]:
    """The shared-memory bytes a block of each of the built library's
    kernels takes (static as ptxas allocated them, plus the dynamic bytes
    its launch gives), by kind as smem_bytes keys them: {kind: [bytes of
    each kernel of that kind]}."""
    lib = load_library(family, shape)
    out: Dict[str, list] = {}
    for name, kinds in FAMILIES[family].smem.items():
        got = (_I * len(kinds))()
        check(getattr(lib, name)(got), name)
        for kind, nbytes in zip(kinds, got):
            out.setdefault(kind, []).append(nbytes)
    return out


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
