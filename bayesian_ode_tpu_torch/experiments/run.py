"""Experiment CLI of the port:

    python -m bayesian_ode_tpu_torch.experiments.run --json-dir DIR --id N \
        [--experiment vanderpol|toy] [--data-pickle PATH] [--no-plots] \
        [--device cuda] [--resume] [--backend nccl|gloo]

A JSON config selected by integer id, as the JAX package's CLI; the
config's "data" block {ode, N, T, t_max, noise, x0_scale, seed} regenerates
the dataset with the port's own generator, or `--data-pickle` reads a
reference-format data pickle ({N, R, noise, x0, t, X, Y, ODE}) instead, so
that both packages' CLIs can run a config on the same data.
`--experiment toy` runs each config's toy-density sampler
(`experiments.toy.run_toy`) instead.  The run goes to the first CUDA card;
with no card it stops with an error unless `--device cpu` is given.
`--resume` continues each config's interrupted sampling run from its
sampler_ckpt.npz (configs with ckpt_every > 0).

`--id all` runs the whole grid: every process of a launched fleet
(`torchrun`, or a SLURM job of several tasks; `parallel.init_runtime`)
takes its contiguous slice of the sorted numeric config ids of
`--json-dir` (`parallel.process_slice`); a single process runs them all in
turn.  `--backend` names the fleet's `torch.distributed` backend (default:
nccl on the card, gloo on the CPU).
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np
import torch

from ..models import make_dataset
from .config import load_config
from .toy import run_toy
from .vanderpol_gp import worker


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json-dir", required=True)
    ap.add_argument("--id", required=True,
                    help="integer config id, or 'all' for this process's "
                         "slice of the whole grid (fleet aware)")
    ap.add_argument("--experiment", default="vanderpol",
                    choices=["vanderpol", "toy"])
    ap.add_argument("--data-pickle", default=None,
                    help="load a reference-format data pickle "
                         "({N,R,noise,x0,t,X,Y,ODE} dict) instead of "
                         "regenerating the dataset")
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; the CPU runs the "
                         "kernels' plain versions only when asked)")
    ap.add_argument("--resume", action="store_true",
                    help="resume an interrupted sampling run from its "
                         "sampler_ckpt.npz (needs config ckpt_every > 0; "
                         "the resumed chain equals an uninterrupted run)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend of a launched fleet "
                         "(--id all; default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)
    if args.id != "all" and not args.id.isdigit():
        ap.error(f"--id must be an integer or 'all', got {args.id!r}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: the port runs on the card; pass "
                 "--device cpu to run the plain versions on the CPU")

    if args.id != "all":
        _run_one(args, int(args.id), device)
        return
    from ..parallel import init_runtime, process_slice

    rt = init_runtime(backend=args.backend, device=device)
    ids = sorted(
        int(os.path.splitext(os.path.basename(p))[0])
        for p in glob.glob(os.path.join(args.json_dir, "*.json"))
        if os.path.splitext(os.path.basename(p))[0].isdigit())
    mine = ids[process_slice(len(ids), rt)]
    print(f"[process {rt.process_index}/{rt.process_count}] "
          f"config ids {mine}")
    for rid in mine:
        _run_one(args, rid, device)


def load_data_pickle(path: str, device) -> dict:
    """A reference-format data pickle ({N, R, noise, x0, t, X, Y, ODE}) with
    x0, t, X and Y as tensors on `device` in the pickle's own dtypes; the
    other entries as they are.  Unpickling runs code: read only pickles
    that this project or the reference wrote."""
    with open(path, "rb") as f:
        raw = pickle.load(f)
    return {k: (torch.as_tensor(np.asarray(v), device=device)
                if k in ("x0", "t", "X", "Y") else v)
            for k, v in raw.items()}


def _run_one(args, run_id: int, device):
    blob = load_config(args.json_dir, run_id)
    if args.experiment == "toy":
        for cfg in blob["configs"]:
            print(run_toy(cfg, blob["output"], make_plots=not args.no_plots,
                          device=device))
        return
    if args.data_pickle:
        data = load_data_pickle(args.data_pickle, device)
    else:
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
