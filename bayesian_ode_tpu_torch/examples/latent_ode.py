"""Latent ODE VAE on 2-D spirals (reference neuralode_examples/latent_ode.py).

  python -m bayesian_ode_tpu_torch.examples.latent_ode --niters 500 \
      --train-dir DIR [--device cpu]

The latent trajectories go through `odeint_adjoint` (dopri5 at rtol 1e-5,
atol 1e-7) with the field's parameters as the adjoint's parameters.  The
whole training state (parameters, Adam's moments, the iteration) is
checkpointed to --train-dir every --ckpt-every iterations with
`utils.checkpoint`, and a run resumes from it (the reference's
interrupt/resume flow, latent_ode.py:233-293).
"""
from __future__ import annotations

import argparse
import os

import torch

from .. import odeint_adjoint
from ..models import latent_ode
from ..utils.checkpoint import load_pytree, save_pytree
from ..utils.logging import RunLogger
from ..utils.meters import RunningAverageMeter
from ..utils.pytree import tree_leaves
from . import adam_tree, add_device, device_arg, load_adam_tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--niters", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--nspiral", type=int, default=1000)
    ap.add_argument("--train-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--visualize", action="store_true")
    add_device(ap)
    args = ap.parse_args(argv)
    device = device_arg(ap, args)

    _, samp, _, samp_ts = latent_ode.generate_spiral2d(
        nspiral=args.nspiral, noise_std=0.3)
    samp = torch.as_tensor(samp, dtype=torch.float32, device=device)
    ts = torch.as_tensor(samp_ts, dtype=torch.float32, device=device)

    params = latent_ode.init_params(
        torch.Generator(device=device).manual_seed(0), device=device)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    opt = torch.optim.Adam(leaves, lr=args.lr)
    start_iter = 0

    ckpt_path = None
    if args.train_dir is not None:
        os.makedirs(args.train_dir, exist_ok=True)
        ckpt_path = os.path.join(args.train_dir, "ckpt.npz")
        if os.path.exists(ckpt_path):
            like = {"params": params, "opt_state": adam_tree(opt, leaves),
                    "iter": torch.zeros((), dtype=torch.int64)}
            state = load_pytree(ckpt_path, like)
            with torch.no_grad():
                for p, v in zip(leaves, tree_leaves(state["params"])):
                    p.copy_(v)
            load_adam_tree(opt, leaves, state["opt_state"])
            start_iter = int(state["iter"])
            print(f"resumed from {ckpt_path} at iter {start_iter}")

    func_leaves = tree_leaves(params["func"])

    def solve(f, z0, t):
        return odeint_adjoint(f, z0, t, rtol=1e-5, atol=1e-7,
                              method="dopri5", adjoint_params=func_leaves)

    loss_fn = latent_ode.make_loss(solve, samp, ts, noise_std=0.3)
    logger = RunLogger(
        os.path.join(args.train_dir, "run.jsonl") if args.train_dir else None,
        echo=True)
    meter = RunningAverageMeter()
    gen = torch.Generator(device=device).manual_seed(1 + start_iter)
    record = {}
    for itr in range(start_iter + 1, args.niters + 1):
        opt.zero_grad()
        loss = loss_fn(params, gen)
        loss.backward()
        opt.step()
        meter.update(float(loss.detach()))
        record = {"iter": itr, "running_avg_elbo": -meter.avg,
                  "loss": float(loss.detach())}
        if itr % 20 == 0 or itr == args.niters:
            logger.log(record)
        if ckpt_path is not None and itr % args.ckpt_every == 0:
            save_pytree(ckpt_path, {
                "params": params, "opt_state": adam_tree(opt, leaves),
                "iter": torch.tensor(itr)})
    logger.close()

    if args.visualize and args.train_dir:
        _viz(params, samp, ts, solve, args.train_dir)
    return record


def _viz(params, samp, ts, solve, out_dir):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with torch.no_grad():
        mu, _ = latent_ode.encode(params["rec"], samp[:8])
        zs = solve(lambda t, z: latent_ode.latent_field(params["func"], t, z),
                   mu, ts)
        xs = latent_ode.decode(params["dec"], zs.movedim(0, 1)).cpu()
    samp = samp.cpu()
    fig, ax = plt.subplots(figsize=(5, 5))
    for i in range(4):
        ax.plot(samp[i, :, 0], samp[i, :, 1], ".", ms=2)
        ax.plot(xs[i, :, 0], xs[i, :, 1], "-")
    fig.savefig(os.path.join(out_dir, "vis.png"), dpi=120)
    plt.close(fig)


if __name__ == "__main__":
    main()
