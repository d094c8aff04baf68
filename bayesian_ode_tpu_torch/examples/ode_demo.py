"""Spiral neural-ODE demo (reference neuralode_examples/ode_demo.py).

  python -m bayesian_ode_tpu_torch.examples.ode_demo --niters 500 \
      --adjoint [--viz] [--device cpu]

Trains the Linear-Tanh-Linear field on y^3 against the true spiral
dy/dt = y^3 A with RMSprop (decay 0.9, optax's rmsprop default, not
torch's 0.99) on random sub-trajectory minibatches; --adjoint takes the
gradient by the continuous adjoint instead of autograd through the
solver (the reference's import switch, ode_demo.py:22-25).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from .. import odeint, odeint_adjoint
from ..models import spiral
from ..utils.logging import RunLogger
from ..utils.meters import RunningAverageMeter
from ..utils.pytree import tree_leaves
from . import add_device, device_arg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="dopri5",
                    choices=["dopri5", "tsit5", "adams", "rk4"])
    ap.add_argument("--data-size", type=int, default=1000)
    ap.add_argument("--batch-time", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=20)
    ap.add_argument("--niters", type=int, default=2000)
    ap.add_argument("--test-freq", type=int, default=20)
    ap.add_argument("--adjoint", action="store_true")
    ap.add_argument("--viz", action="store_true")
    ap.add_argument("--log", default=None)
    add_device(ap)
    args = ap.parse_args(argv)
    device = device_arg(ap, args)
    f64 = torch.float64

    t = torch.linspace(0.0, 25.0, args.data_size, dtype=f64, device=device)
    y0 = torch.as_tensor(spiral.TRUE_Y0, dtype=f64, device=device)
    with torch.no_grad():
        true_y = odeint(spiral.true_field, y0, t, method="dopri5")

    params = spiral.init_params(torch.Generator(device=device).manual_seed(0),
                                device=device)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    if args.adjoint:
        def solve(f, y, tt):
            return odeint_adjoint(f, y, tt, rtol=1e-7, atol=1e-9,
                                  method=args.method, adjoint_params=leaves)
    else:
        opts = {"mode": "bounded"} if args.method in ("dopri5", "tsit5",
                                                      "adams") else None

        def solve(f, y, tt):
            return odeint(f, y, tt, method=args.method, options=opts)

    opt = torch.optim.RMSprop(leaves, lr=1e-3, alpha=0.9)
    gen = torch.Generator().manual_seed(1)      # the minibatch windows
    logger = RunLogger(args.log, echo=True)
    time_meter = RunningAverageMeter(0.97)
    loss_meter = RunningAverageMeter(0.97)
    record = {}
    end = time.time()
    for itr in range(1, args.niters + 1):
        by0, bt, by = spiral.get_batch(gen, true_y, t, args.batch_time,
                                       args.batch_size)
        opt.zero_grad()
        loss = spiral.make_loss(solve, by0, bt, by)(params)
        loss.backward()
        opt.step()
        time_meter.update(time.time() - end)
        loss_meter.update(float(loss.detach()))
        record = {"iter": itr, "batch_loss": loss_meter.avg,
                  "sec_per_iter": time_meter.avg}
        if itr % args.test_freq == 0 or itr == args.niters:
            with torch.no_grad():
                pred = solve(lambda tt, y: spiral.vector_field(params, tt,
                                                               y), y0, t)
            record["total_loss"] = float((pred - true_y).abs().mean())
            logger.log(record)
            if args.viz:
                _viz(true_y.cpu().numpy(), pred.cpu().numpy(), itr)
        end = time.time()
    logger.close()
    return record


def _viz(true_y, pred_y, itr, out_dir="png"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(true_y[:, 0], true_y[:, 1], "g-", label="true")
    ax.plot(pred_y[:, 0], pred_y[:, 1], "b--", label="pred")
    ax.legend()
    fig.savefig(os.path.join(out_dir, f"{itr:05d}.png"), dpi=100)
    plt.close(fig)


if __name__ == "__main__":
    main()
