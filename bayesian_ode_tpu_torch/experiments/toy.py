"""2-D toy-density sampler experiments (counterpart of
`bayesian_ode_tpu/experiments/toy.py`; reference
scripts/toy/toy_plots.py:126-459).

Per-sampler runs over the banana, Gaussian and mixture targets on the
port's single-chain samplers (`init_chains`, then `sample_chains`, chain
after chain where the JAX package vmaps), with scatter and density plots
and step-size-weighted posterior means for decreasing-step samplers
(toy_plots.py:229-234).  The random streams are the port's generators,
so the draws differ from the JAX package's; the moments agree.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from .. import samplers
from ..models import TOY_POTENTIALS
from ..samplers import schedules
from ..utils.logging import RunLogger


def _decay(config: Dict):
    return schedules.polynomial_decay(config["lr0"], config["lr_gamma"],
                                      config["lr_t0"],
                                      config.get("lr_alpha", 1.0))


def make_toy_sampler(config: Dict, potential):
    method = config["method"]
    if method == "MALA":
        return samplers.mala(potential, config["lr"])
    if method == "SGLD":
        return samplers.sgld(potential, _decay(config))
    if method == "pSGLD":
        return samplers.psgld(potential, _decay(config),
                              alpha=config.get("psgld_alpha", 0.99),
                              lambda_=config.get("lambda_", 1e-5))
    if method == "aSGHMC":
        return samplers.asghmc(potential, config["lr"],
                               burn_in_steps=config["burn_in"],
                               mom_decay=config.get("mom_decay", 5e-2))
    if method == "PT":
        # replica exchange: the mixture and grid toys are the targets
        # single-temperature kernels get stuck on
        return samplers.parallel_tempering(
            potential,
            samplers.temperature_ladder(config.get("num_replicas", 6),
                                        config.get("beta_min", 0.05)),
            step_size=config["lr"], inner=config.get("pt_inner", "mala"),
            swap_every=config.get("swap_every", 1))
    raise ValueError(f"unknown toy sampler {method!r}")


def weighted_posterior_mean(positions, step_sizes):
    """Step-size-weighted mean sum(lr_t * x_t)/sum(lr_t) for
    decreasing-step samplers (toy_plots.py:229-234)."""
    w = step_sizes / step_sizes.sum(dim=-1, keepdim=True)
    return (positions * w[..., None]).sum(dim=(-3, -2)) \
        / positions.shape[-3]


def run_toy(config: Dict, output: str,
            dists=("banana", "gauss", "multimodal"), make_plots: bool = True,
            device="cuda", dtype=torch.float32) -> Dict:
    """Sample each toy density with the configured sampler over
    config["num_chains"] chains (default 16) from the origin ((2, 4) for
    "gauss") jittered by N(0, 0.25), in `dtype` on `device` (the card
    unless the caller asks for the CPU).  Writes {output}/{method}/{id}.json
    and run.jsonl, and with make_plots {id}_densities.pdf; returns each
    density's mean, weighted mean, acceptance and ESS of x."""
    out_dir = os.path.join(output, config["method"])
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{config.get('id', 0)}.json"), "w") as f:
        json.dump(config, f, indent=2, default=str)
    for name in dists:
        if name not in TOY_POTENTIALS:
            raise ValueError(f"unknown toy density {name!r}; expected one "
                             f"of {sorted(TOY_POTENTIALS)}")

    n_chains = config.get("num_chains", 16)
    seed = config.get("seed", 0)
    results = {}
    flats = []
    with RunLogger(os.path.join(out_dir, "run.jsonl")) as logger:
        for name in dists:
            kernel = make_toy_sampler(config, TOY_POTENTIALS[name]())
            x0 = torch.tensor([2.0, 4.0] if name == "gauss" else [0.0, 0.0],
                              dtype=dtype, device=device)
            states = samplers.init_chains(
                kernel, torch.Generator(device=device).manual_seed(seed), x0,
                n_chains, jitter=0.5)
            _, pos, infos = samplers.sample_chains(
                kernel, states,
                torch.Generator(device=device).manual_seed(seed + 1),
                num_samples=config["num_samples"], burn_in=config["burn_in"],
                thin=config.get("thinning", 1))
            steps = torch.as_tensor(infos["step_size"]).to(pos)
            wmean = (pos * (steps / steps.sum(-1, keepdim=True))[..., None]
                     ).sum(dim=1).mean(0)
            flat = pos.reshape(-1, 2).cpu().numpy()
            results[name] = {
                "mean": flat.mean(0).tolist(),
                "weighted_mean": wmean.cpu().numpy().tolist(),
                "acceptance": float(torch.as_tensor(
                    infos["accepted"]).float().mean()),
                "ess_x": float(samplers.ess(pos[:, :, 0]))}
            logger.log({"event": "toy", "dist": name, **results[name]})
            flats.append(flat)

    if make_plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(ncols=len(dists), nrows=1, dpi=150,
                                 figsize=(4 * len(dists), 4))
        for ax, name, flat in zip(np.atleast_1d(axes), dists, flats):
            ax.hist2d(flat[:, 0], flat[:, 1], bins=60, cmap="binary")
            ax.plot(flat[::97, 0], flat[::97, 1], ".", ms=1, alpha=0.3)
            ax.set_title(f"{name} ({config['method']})")
        fig.savefig(os.path.join(out_dir,
                                 f"{config.get('id', 0)}_densities.pdf"))
        plt.close(fig)
    return results
