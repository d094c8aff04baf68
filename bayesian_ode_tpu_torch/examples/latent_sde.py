"""Latent SDE on noisy damped oscillations (Li et al. 2020; the stochastic
counterpart of the latent ODE VAE, neuralode_examples/latent_ode.py).

  python -m bayesian_ode_tpu_torch.examples.latent_sde --niters 800 \
      --train-dir DIR [--device cpu]

The same interrupt/resume flow as `latent_ode` (the whole training state
checkpointed every --ckpt-every iterations); --visualize writes the data
overlaid with posterior reconstructions and prior draws.
"""
from __future__ import annotations

import argparse
import math
import os

import torch

from ..models import latent_sde
from ..utils.checkpoint import load_pytree, save_pytree
from ..utils.logging import RunLogger
from ..utils.meters import RunningAverageMeter
from ..utils.pytree import tree_leaves
from . import adam_tree, add_device, device_arg, load_adam_tree


def generate_oscillations(generator: torch.Generator, n: int = 256,
                          T: int = 40, t1: float = 6.0,
                          noise_std: float = 0.05, device=None):
    """Noisy 2-D damped oscillators with random phase and decay, whose
    path-to-path variability a deterministic latent path cannot carry.
    Returns (ts (T,) float64, xs (n, T, 2) float32) from `generator`."""
    ts = torch.linspace(0.0, t1, T, dtype=torch.float64, device=device)
    phase = torch.rand((n, 1), generator=generator, device=device) \
        * 2 * math.pi
    decay = 0.1 + 0.2 * torch.rand((n, 1), generator=generator,
                                   device=device)
    t32 = ts.to(torch.float32)[None]
    env = torch.exp(-decay * t32)
    xs = torch.stack([env * torch.sin(t32 + phase),
                      env * torch.cos(t32 + phase)], dim=-1)
    xs = xs + noise_std * torch.randn(xs.shape, generator=generator,
                                      device=device)
    return ts, xs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--niters", type=int, default=800)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--ntraj", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--substeps", type=int, default=3)
    ap.add_argument("--latent-dim", type=int, default=4)
    ap.add_argument("--noise-std", type=float, default=0.05)
    ap.add_argument("--kl-anneal", type=int, default=200,
                    help="linear KL warm-up iterations (0 disables)")
    ap.add_argument("--train-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--visualize", action="store_true")
    add_device(ap)
    args = ap.parse_args(argv)
    device = device_arg(ap, args)

    ts, xs = generate_oscillations(
        torch.Generator(device=device).manual_seed(0), n=args.ntraj,
        noise_std=args.noise_std, device=device)
    params = latent_sde.init_params(
        torch.Generator(device=device).manual_seed(1),
        latent_dim=args.latent_dim, obs_dim=2, device=device)
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

    logger = RunLogger(
        os.path.join(args.train_dir, "run.jsonl") if args.train_dir else None,
        echo=True)
    meter = RunningAverageMeter()
    gen = torch.Generator(device=device).manual_seed(2 + start_iter)
    gen_idx = torch.Generator().manual_seed(3 + start_iter)
    n = xs.shape[0]
    record = {}
    for itr in range(start_iter + 1, args.niters + 1):
        idx = torch.randperm(n, generator=gen_idx)[:args.batch].to(device)
        kl_w = (1.0 if args.kl_anneal <= 0
                else min(1.0, itr / args.kl_anneal))
        loss_fn = latent_sde.make_loss(ts, xs[idx], noise_std=args.noise_std,
                                       substeps=args.substeps,
                                       kl_weight=kl_w)
        opt.zero_grad()
        loss = loss_fn(params, gen)
        loss.backward()
        opt.step()
        meter.update(float(loss.detach()))
        record = {"iter": itr, "running_avg_neg_elbo": meter.avg,
                  "loss": float(loss.detach()), "kl_weight": kl_w}
        if itr % 20 == 0 or itr == args.niters:
            logger.log(record)
        if ckpt_path is not None and itr % args.ckpt_every == 0:
            save_pytree(ckpt_path, {
                "params": params, "opt_state": adam_tree(opt, leaves),
                "iter": torch.tensor(itr)})
    logger.close()

    if args.visualize and args.train_dir:
        _viz(params, ts, xs, args.train_dir, device)
    return record


def _viz(params, ts, xs, out_dir, device):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with torch.no_grad():
        recon = latent_sde.sample_posterior(
            params, torch.Generator(device=device).manual_seed(3), ts,
            xs[:4]).cpu()
        prior = latent_sde.sample_prior(
            params, torch.Generator(device=device).manual_seed(4), ts,
            4).cpu()
    xs = xs.cpu()
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    for i in range(4):
        axes[0].plot(xs[i, :, 0], xs[i, :, 1], ".", ms=2)
        axes[0].plot(recon[i, :, 0], recon[i, :, 1], "-")
        axes[1].plot(prior[i, :, 0], prior[i, :, 1], "-")
    axes[0].set_title("data + posterior reconstruction")
    axes[1].set_title("prior draws")
    fig.savefig(os.path.join(out_dir, "vis.png"), dpi=120)
    plt.close(fig)


if __name__ == "__main__":
    main()
