"""ODEnet image classification (reference neuralode_examples/odenet_mnist.py).

  python -m bayesian_ode_tpu_torch.examples.odenet_mnist --niters 200 \
      --tol 1e-3 [--device cpu]

With no network and no bundled MNIST, the example trains by default on
synthetic structured digits of MNIST's shape (1x28x28, 10 classes); pass
--mnist-npz PATH for a real .npz with x_train (N, 28, 28) uint8 and
y_train (N,) (the layout `examples/make_digits_npz.py` writes).  SGD with
momentum 0.9; the ODE block is dopri5 in bounded mode (32 steps an
interval at most, autograd through the loop) or rk4; every 50 iterations
and at the last it logs the test accuracy and the forward NFE of the ODE
block (from `odeint_with_stats`, the reference's nfe meters).
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from .. import odeint, odeint_with_stats
from ..models import odenet
from ..utils.logging import RunLogger
from ..utils.meters import RunningAverageMeter
from ..utils.pytree import tree_leaves
from . import add_device, device_arg


def synthetic_digits(generator: torch.Generator, n: int, size: int = 28,
                     device=None):
    """Structured classes: oriented bar patterns times a shifted blob plus
    noise, learnable but not trivial.  Returns (images (n, 1, size, size)
    float32, labels (n,) int64), drawn from `generator` (on `device`)."""
    labels = torch.randint(0, 10, (n,), generator=generator, device=device)
    lin = torch.linspace(-1.0, 1.0, size, device=device)
    xx, yy = torch.meshgrid(lin, lin, indexing="xy")
    lab = labels.to(torch.float32)[:, None, None]
    angle = lab * math.pi / 10.0
    stripe = torch.sin(6.0 * (xx * torch.cos(angle) + yy * torch.sin(angle))
                       + 0.3 * lab)
    blob = torch.exp(-((xx - 0.05 * lab) ** 2 + yy ** 2) * 3.0)
    img = stripe * blob + 0.2 * torch.randn(
        (n, size, size), generator=generator, device=device)
    return img[:, None], labels


def load_npz(path: str, device):
    """x_train (N, 28, 28) uint8 and y_train (N,) of an MNIST-layout .npz
    as (images (N, 1, 28, 28) in [0, 1], labels (N,) int64)."""
    with np.load(path) as d:
        x = torch.as_tensor(d["x_train"][:, None], dtype=torch.float32,
                            device=device) / 255.0
        y = torch.as_tensor(d["y_train"], dtype=torch.int64, device=device)
    return x, y


def make_solver(method: str, tol: float):
    """odeint_fn(field, h0, ts) of the ODE block."""
    if method == "rk4":
        return lambda f, h0, t: odeint(f, h0, t, method="rk4")
    opts = {"mode": "bounded", "max_steps_per_interval": 32}
    return lambda f, h0, t: odeint(f, h0, t, rtol=tol, atol=tol,
                                   method="dopri5", options=opts)


def forward_nfe(params, images, tol: float) -> int:
    """The ODE block's forward NFE at `images` (dopri5 at tol)."""
    h = odenet.downsample(params["down"], images)
    ts = torch.tensor([0.0, 1.0], dtype=torch.float64, device=images.device)
    _, st = odeint_with_stats(
        lambda t, hh: odenet.ode_field(params["odefunc"], t, hh), h, ts,
        tol, tol, "dopri5")
    return int(st["nfe"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--niters", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--solver", default="dopri5", choices=["dopri5", "rk4"])
    ap.add_argument("--network", default="odenet",
                    choices=["odenet", "resnet"])
    ap.add_argument("--mnist-npz", default=None)
    ap.add_argument("--log", default=None)
    add_device(ap)
    args = ap.parse_args(argv)
    device = device_arg(ap, args)

    if args.mnist_npz:
        x, y = load_npz(args.mnist_npz, device)
    else:
        x, y = synthetic_digits(
            torch.Generator(device=device).manual_seed(0), 4096,
            device=device)
    n_train = int(0.9 * x.shape[0])
    x_train, y_train = x[:n_train], y[:n_train]
    x_test, y_test = x[n_train:], y[n_train:]

    params = odenet.init_params(torch.Generator(device=device).manual_seed(1),
                                dim=args.dim, network=args.network,
                                device=device)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    opt = torch.optim.SGD(leaves, lr=args.lr, momentum=0.9)
    solve = make_solver(args.solver, args.tol)
    gen = torch.Generator(device=device).manual_seed(2)

    logger = RunLogger(args.log, echo=True)
    tmeter = RunningAverageMeter(0.97)
    record = {}
    end = time.time()
    for itr in range(1, args.niters + 1):
        idx = torch.randint(0, n_train, (args.batch_size,), generator=gen,
                            device=device)
        opt.zero_grad()
        loss = odenet.make_loss(solve, x_train[idx], y_train[idx])(params)
        loss.backward()
        opt.step()
        val = float(loss.detach())
        tmeter.update(time.time() - end)
        record = {"iter": itr, "loss": val, "sec_per_iter": tmeter.avg}
        if itr % 50 == 0 or itr == args.niters:
            with torch.no_grad():
                acc = odenet.accuracy(params, x_test[:512], y_test[:512],
                                      solve)
                nfe = forward_nfe(params, x_test[:8], args.tol)
            record.update(test_acc=float(acc), nfe_forward=nfe)
            logger.log(record)
        end = time.time()
    logger.close()
    return record


if __name__ == "__main__":
    main()
