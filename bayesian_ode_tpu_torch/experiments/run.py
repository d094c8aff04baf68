"""Experiment CLI of the port:

    python -m bayesian_ode_tpu_torch.experiments.run --json-dir DIR --id N \
        --no-plots [--device cuda]

A JSON config selected by integer id, as the JAX package's CLI; the
config's "data" block {ode, N, T, t_max, noise, x0_scale, seed} regenerates
the dataset with the port's own generator.  The device defaults to the
first CUDA card when there is one.
"""
from __future__ import annotations

import argparse

import torch

from ..models import make_dataset
from .config import load_config
from .vanderpol_gp import worker


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json-dir", required=True)
    ap.add_argument("--id", required=True, type=int)
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda if available, else "
                         "cpu)")
    args = ap.parse_args(argv)
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")

    blob = load_config(args.json_dir, args.id)
    dspec = blob.get("data", {})
    data = make_dataset(
        seed=dspec.get("seed", 0), ode=dspec.get("ode", "vdp"),
        N=dspec.get("N", 5), T=dspec.get("T", 60),
        t_max=dspec.get("t_max", 6.0), noise=dspec.get("noise", 0.05),
        x0_scale=dspec.get("x0_scale", 1.5))
    for cfg in blob["configs"]:
        print(worker(cfg, data, blob["output"],
                     make_plots=not args.no_plots, device=device))


if __name__ == "__main__":
    main()
