"""The SVGD direction phi with the RBF kernel, without the n x n kernel
matrix in device memory.

Counterpart of `bayesian_ode_tpu/ops/pallas_rbf.py`.  The TPU kernel
`_phi_kernel` (K8, launched by `svgd_phi_pallas`) becomes the CUDA kernels
of `csrc/svgd_phi.cu`: a block owns a tile of particle rows and a
contiguous range of column tiles (the columns are split S ways, S picked
from n and the card's SM count to fill it), forms each tile of
K = exp(-gamma d2) in shared memory and accumulates sum_j K_ij,
sum_j K_ij s_j and sum_j K_ij (x_j - c) in registers; a second kernel adds
the S partial sums in order and writes the (n, d) rows of phi:

    phi_i = (sum_j K_ij s_j + 2 gamma (x_i sum_j K_ij - sum_j K_ij x_j)) / n

with d2 = max(|x_i|^2 + |x_j|^2 - 2 x_i . x_j, 0), the norm expansion of
the TPU kernel, evaluated in float32 on particles centred on c, the row
tile's first particle (both terms are translation-invariant), so it does
not cancel on a clustered ensemble.  The kernels take any n and d and
mask the ragged edge themselves, so the TPU's padding to whole tiles
(far-away particle rows, 128 feature lanes) and its `tile_rows`/
`tile_cols`/`interpret` options have no counterpart.  The bandwidth gamma
is the caller's (a global median, see `samplers/stein.py::rbf_bandwidth`);
it stays on the card.

`svgd_phi` launches the kernels for CUDA tensors, with the partial sums in
a workspace of S * n * (2d + 1) floats from `torch.empty`, and takes the
plain version, `svgd_phi_reference` (the matmul form, not centred), for
CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build
from .fused_adaptive import _check_args, _stream


def svgd_phi_reference(particles, scores, gamma):
    """Plain version of K8, on any device and dtype: phi (n, d) for
    particles and scores (n, d) at the bandwidth gamma (a float or a 0-d
    tensor), the matmul form of `samplers.stein.svgd_direction`."""
    xx = (particles * particles).sum(dim=1)
    d2 = torch.clamp_min(
        xx[:, None] + xx[None, :] - 2.0 * particles @ particles.T, 0.0)
    K = torch.exp(-gamma * d2)
    ksum = K.sum(dim=1)
    grad_K = 2.0 * gamma * (particles * ksum[:, None] - K @ particles)
    return (K @ scores + grad_K) / particles.shape[0]


_SPLITS: Dict[Tuple[int, int, int], int] = {}


def splits(n: int, d: int, device) -> int:
    """The column splits S the kernel takes for n particles of width d on
    this CUDA device: about one wave of resident blocks (1 where the row
    tiles fill the card), from its SM count; cached by device, n and d."""
    device = torch.device(device)
    key = (device.index or 0, int(n), int(d))
    if key not in _SPLITS:
        lib = _build.load_library("svgd_phi", ())
        got = ctypes.c_int()
        with torch.cuda.device(device):
            _build.check(lib.svgd_phi_splits(n, d, ctypes.byref(got)),
                         "svgd_phi_splits")
        _SPLITS[key] = got.value
    return _SPLITS[key]


def _launch(particles, scores, gamma):
    n, d = particles.shape
    dev = particles.device
    f32 = torch.float32
    gamma = torch.as_tensor(gamma, dtype=f32, device=dev).reshape(1)
    _check_args(dev, particles=(particles, (n, d), f32),
                scores=(scores, (n, d), f32), gamma=(gamma, (1,), f32))
    out = torch.empty_like(particles)
    if n == 0 or d == 0:
        return out
    lib = _build.load_library("svgd_phi", ())
    with torch.cuda.device(dev):
        S = splits(n, d, dev)
        work = torch.empty((S, n, 2 * d + 1), dtype=f32, device=dev)
        status = lib.svgd_phi(particles.data_ptr(), scores.data_ptr(),
                              gamma.data_ptr(), n, d, S, work.data_ptr(),
                              out.data_ptr(), _stream(dev))
    _build.check(status, "svgd_phi")
    _build.launch_counts["svgd_phi"] += 1
    return out


def svgd_phi(particles, scores, gamma):
    """phi (n, d) of float32 particles and scores (n, d) at the bandwidth
    gamma, divided by n as `svgd_phi_pallas` returns it: kernel K8 (two
    launches, one count) for CUDA tensors, the plain version for CPU
    tensors."""
    if particles.is_cuda:
        return _launch(particles, scores, gamma)
    if particles.device.type != "cpu":
        raise ValueError(f"unsupported device {particles.device}")
    return svgd_phi_reference(particles, scores, gamma)
