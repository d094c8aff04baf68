"""ODEnet for MNIST-style image classification.

Counterpart of `bayesian_ode_tpu/models/odenet.py` (reference:
neuralode_examples/odenet_mnist.py): a conv net whose residual stack is
one ODE block integrating a GroupNorm + time-concat conv field over t in
[0, 1], a downsampling head and a pooled linear classifier; with
network="resnet" six residual blocks take the ODE block's place.

Parameters are plain dicts of tensors in the port's NCHW layout, the
convolution weights OIHW; `params_from_numpy` carries the JAX package's
HWIO weights across.  Convolutions pad as XLA's "SAME" does
(`same_padding`): `F.conv2d(padding="same")` refuses stride 2, and XLA
puts the odd pixel of an even kernel's padding after the input.  The
field is the right-hand side of an adaptive solve, so on the card its
float32 convolutions run without TF32 (`kernel_regression.full_f32_matmul`).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .kernel_regression import full_f32_matmul


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one spatial axis under XLA's "SAME": the
    output has ceil(size / stride) pixels, the total padding is
    max((out - 1) stride + k - size, 0), the odd pixel goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(p, x, stride: int = 1):
    k = p["w"].shape[-1]
    (hl, hh), (wl, wh) = (same_padding(x.shape[2], k, stride),
                          same_padding(x.shape[3], k, stride))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), p["w"], p["b"],
                    stride=stride)


def _group_norm(p, x, groups: int = 32, eps: float = 1e-5):
    """GroupNorm over min(groups, C) groups with the biased variance."""
    return F.group_norm(x, min(groups, x.shape[1]), p["scale"], p["bias"],
                        eps)


def _uniform(generator, shape, bound, dtype, device):
    return (torch.rand(shape, generator=generator, dtype=dtype,
                       device=device) * 2.0 - 1.0) * bound


def _conv_init(generator, k, c_in, c_out, dtype, device):
    # torch Conv2d's default: U(+-1/sqrt(fan_in))
    bound = 1.0 / math.sqrt(c_in * k * k)
    return {"w": _uniform(generator, (c_out, c_in, k, k), bound, dtype,
                          device),
            "b": _uniform(generator, (c_out,), bound, dtype, device)}


def _gn_init(c, dtype, device):
    return {"scale": torch.ones(c, dtype=dtype, device=device),
            "bias": torch.zeros(c, dtype=dtype, device=device)}


def init_resblock(generator: torch.Generator, dim: int,
                  dtype=torch.float32, device=None):
    """Pre-activation residual block (odenet_mnist.py:48-74)."""
    return {"gn1": _gn_init(dim, dtype, device),
            "conv1": _conv_init(generator, 3, dim, dim, dtype, device),
            "gn2": _gn_init(dim, dtype, device),
            "conv2": _conv_init(generator, 3, dim, dim, dtype, device)}


def resblock(params, x):
    out = F.relu(_group_norm(params["gn1"], x))
    out = _conv(params["conv1"], out)
    out = F.relu(_group_norm(params["gn2"], out))
    out = _conv(params["conv2"], out)
    return out + x


def init_params(generator: torch.Generator, dim: int = 64,
                n_classes: int = 10, network: str = "odenet",
                n_resblocks: int = 6, dtype=torch.float32,
                device=None) -> Dict:
    """Random parameters (torch's default initialisations) from
    `generator`; network="resnet" adds `n_resblocks` residual blocks that
    replace the ODE block (the reference's baseline switch,
    odenet_mnist.py:304)."""
    if network not in ("odenet", "resnet"):
        raise ValueError(f"network must be 'odenet' or 'resnet', got "
                         f"{network!r}")

    def conv(k, c_in, c_out):
        return _conv_init(generator, k, c_in, c_out, dtype, device)

    def gn(c):
        return _gn_init(c, dtype, device)

    bound = 1.0 / math.sqrt(dim)
    params = {
        "down": {"conv1": conv(3, 1, dim), "gn1": gn(dim),
                 "conv2": conv(4, dim, dim), "gn2": gn(dim),
                 "conv3": conv(4, dim, dim)},
        # time-concat convs: one extra input channel carrying t
        # (odenet_mnist.py:60-75)
        "odefunc": {"gn1": gn(dim), "conv1": conv(3, dim + 1, dim),
                    "gn2": gn(dim), "conv2": conv(3, dim + 1, dim),
                    "gn3": gn(dim)},
        "head": {"gn": gn(dim),
                 "fc": {"w": _uniform(generator, (dim, n_classes), bound,
                                      dtype, device),
                        "b": torch.zeros(n_classes, dtype=dtype,
                                         device=device)}},
    }
    if network == "resnet":
        params["resblocks"] = [init_resblock(generator, dim, dtype, device)
                               for _ in range(n_resblocks)]
    return params


def _full_f32(x) -> None:
    if x.is_cuda:
        full_f32_matmul()


def downsample(params, x):
    """1 -> dim conv and two stride-2 convs (odenet_mnist.py:288-295):
    (N, 1, 28, 28) -> (N, dim, 7, 7)."""
    h = _conv(params["conv1"], x)
    h = F.relu(_group_norm(params["gn1"], h))
    h = _conv(params["conv2"], h, stride=2)
    h = F.relu(_group_norm(params["gn2"], h))
    return _conv(params["conv3"], h, stride=2)


def ode_field(params, t, h):
    """GroupNorm-relu-ConcatConv twice and a final norm
    (odenet_mnist.py:92-114); t enters as an extra first channel."""
    _full_f32(h)

    def concat_t(x):
        tt = torch.as_tensor(t, dtype=x.dtype, device=x.device).expand(
            x.shape[0], 1, x.shape[2], x.shape[3])
        return torch.cat([tt, x], dim=1)

    out = F.relu(_group_norm(params["gn1"], h))
    out = _conv(params["conv1"], concat_t(out))
    out = F.relu(_group_norm(params["gn2"], out))
    out = _conv(params["conv2"], concat_t(out))
    return _group_norm(params["gn3"], out)


def classify(params, h):
    """Head: norm, relu, global mean pool, linear (odenet_mnist.py:296-300)."""
    h = F.relu(_group_norm(params["head"]["gn"], h))
    h = h.mean(dim=(2, 3))
    return h @ params["head"]["fc"]["w"] + params["head"]["fc"]["b"]


def forward(params, x, odeint_fn: Callable = None):
    """The whole network on images x (N, 1, H, W): downsample, the feature
    stack, the classifier.  With `odeint_fn(field, h0, ts)` the feature
    stack is one ODE block over [0, 1]; parameters made with
    network="resnet" run their residual blocks instead."""
    _full_f32(x)
    h = downsample(params["down"], x)
    if "resblocks" in params:
        for blk in params["resblocks"]:
            h = resblock(blk, h)
    else:
        ts = torch.tensor([0.0, 1.0], dtype=torch.float64, device=x.device)
        h = odeint_fn(lambda t, hh: ode_field(params["odefunc"], t, hh),
                      h, ts)[-1]
    return classify(params, h)


def make_loss(odeint_fn: Callable, images, labels) -> Callable:
    """params -> mean cross-entropy of the labels (N,) on the images."""
    def loss(params):
        logp = F.log_softmax(forward(params, images, odeint_fn), dim=-1)
        return -logp.gather(1, labels[:, None]).mean()

    return loss


def accuracy(params, images, labels, odeint_fn: Callable):
    logits = forward(params, images, odeint_fn)
    return (logits.argmax(dim=-1) == labels).to(torch.float32).mean()


def params_from_numpy(params, device="cpu", dtype=torch.float32):
    """The JAX package's ODEnet parameters (HWIO convolutions, NHWC) as the
    port's: convolution weights OIHW, every leaf a tensor on `device`."""
    def conv(p):
        w = np.asarray(p["w"])
        return {"w": torch.as_tensor(np.ascontiguousarray(
                    w.transpose(3, 2, 0, 1)), dtype=dtype, device=device),
                "b": torch.as_tensor(np.asarray(p["b"]), dtype=dtype,
                                     device=device)}

    def rec(tree):
        if isinstance(tree, dict) and "w" in tree and np.ndim(tree["w"]) == 4:
            return conv(tree)
        if isinstance(tree, dict):
            return {k: rec(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [rec(v) for v in tree]
        return torch.as_tensor(np.asarray(tree), dtype=dtype, device=device)

    return rec(params)
