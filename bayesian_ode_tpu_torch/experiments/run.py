"""Experiment CLI of the port:

    python -m bayesian_ode_tpu_torch.experiments.run --json-dir DIR --id N \
        [--experiment vanderpol|toy] [--no-plots] [--device cuda] [--resume]

A JSON config selected by integer id, as the JAX package's CLI; the
config's "data" block {ode, N, T, t_max, noise, x0_scale, seed} regenerates
the dataset with the port's own generator.  `--experiment toy` runs each
config's toy-density sampler (`experiments.toy.run_toy`) instead.  The
run goes to the first CUDA card; with no card it stops with an error
unless `--device cpu` is given.
`--resume` continues each config's interrupted sampling run from its
sampler_ckpt.npz (configs with ckpt_every > 0).
"""
from __future__ import annotations

import argparse

import torch

from ..models import make_dataset
from .config import load_config
from .toy import run_toy
from .vanderpol_gp import worker


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json-dir", required=True)
    ap.add_argument("--id", required=True, type=int)
    ap.add_argument("--experiment", default="vanderpol",
                    choices=["vanderpol", "toy"])
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; the CPU runs the "
                         "kernels' plain versions only when asked)")
    ap.add_argument("--resume", action="store_true",
                    help="resume an interrupted sampling run from its "
                         "sampler_ckpt.npz (needs config ckpt_every > 0; "
                         "the resumed chain equals an uninterrupted run)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: the port runs on the card; pass "
                 "--device cpu to run the plain versions on the CPU")

    blob = load_config(args.json_dir, args.id)
    if args.experiment == "toy":
        for cfg in blob["configs"]:
            print(run_toy(cfg, blob["output"], make_plots=not args.no_plots,
                          device=device))
        return
    dspec = blob.get("data", {})
    data = make_dataset(
        seed=dspec.get("seed", 0), ode=dspec.get("ode", "vdp"),
        N=dspec.get("N", 5), T=dspec.get("T", 60),
        t_max=dspec.get("t_max", 6.0), noise=dspec.get("noise", 0.05),
        x0_scale=dspec.get("x0_scale", 1.5))
    for cfg in blob["configs"]:
        if args.resume:
            cfg = dict(cfg, resume=True)
        print(worker(cfg, data, blob["output"],
                     make_plots=not args.no_plots, device=device))


if __name__ == "__main__":
    main()
