"""The examples of the PyTorch port (counterparts of the JAX package's
`examples/`), each run as

    python -m bayesian_ode_tpu_torch.examples.<name> [--device cpu|cuda] ...

`odenet_mnist` (the conv ODEnet on synthetic digits or an MNIST-layout
.npz), `ode_demo` (the spiral neural ODE), `latent_ode` and `latent_sde`
(the latent VAEs, checkpointed and resumable), `bouncing_ball` (a
restitution coefficient learned through `odeint_event`) and
`evidence_model_selection` (the evidence of three inducing grids through
`worker`).  Each has `main(argv=None)`, runs on the card by default and
stops with an error when there is none, unless given `--device cpu`.

Not ported: `make_digits_npz.py`, a numpy/scikit-learn packager whose
.npz `odenet_mnist --mnist-npz` reads as it is, and
`odenet_parity_eval.py`, which evaluates against a checkout of the
reference implementation; the ODEnet's parity tests take its place.
"""
from __future__ import annotations

import argparse

import torch

__all__ = ["adam_tree", "add_device", "device_arg", "load_adam_tree"]


def device_arg(ap: argparse.ArgumentParser, args) -> torch.device:
    """The run's device from `--device`: the card unless the CPU is asked
    for, and an error (not a silent fall-back) when there is no card."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: the examples run on the card; pass "
                 "--device cpu to run them on the CPU")
    return device


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")


def adam_tree(opt: torch.optim.Optimizer, leaves) -> dict:
    """Adam's per-parameter state (zeros before the first step) as a tree
    of tensors for `utils.checkpoint.save_pytree`."""
    out = {"exp_avg": [], "exp_avg_sq": [], "step": []}
    for p in leaves:
        st = opt.state.get(p, {})
        out["exp_avg"].append(st.get("exp_avg", torch.zeros_like(p)))
        out["exp_avg_sq"].append(st.get("exp_avg_sq", torch.zeros_like(p)))
        out["step"].append(st.get("step", torch.zeros(())))
    return out


def load_adam_tree(opt: torch.optim.Optimizer, leaves, tree) -> None:
    """Restore the state `adam_tree` saved into `opt`."""
    for i, p in enumerate(leaves):
        opt.state[p] = {"step": tree["step"][i],
                        "exp_avg": tree["exp_avg"][i],
                        "exp_avg_sq": tree["exp_avg_sq"][i]}
