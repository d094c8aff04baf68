"""GP-ODE experiment driver of the port: the main path.

Counterpart of `bayesian_ode_tpu/experiments/vanderpol_gp.py` for what the
main-path slice runs: model="gp", engine="fused", solver="dopri5", methods
SGLD and pSGLD.  Every chain advances in one batch per sampler step: one
fused forward (kernel K2) and one fused backward (kernel K3) over all
chains.  The artifact layout follows the JAX driver:
{output}/{method}/{id}{dir_name}/ with config.json, run.jsonl (summary),
chain.npz and total_loss_arr.npy.  Every other model, solver, method or
engine raises NotImplementedError naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from .. import samplers
from ..models import kernel_regression as kr
from ..ops.gp_dopri5 import gp_dopri5_solve_whole
from ..ops.gp_dopri5_grad import make_fused_gp_potential_dopri5
from ..samplers import schedules
from ..utils.checkpoint import save_pytree
from ..utils.logging import RunLogger
from ..utils.pytree import tree_map


def _out_dir(output: str, config: Dict) -> str:
    d = os.path.join(output, str(config["method"]),
                     str(config.get("id", 0)) + config.get("dir_name", ""))
    os.makedirs(d, exist_ok=True)
    return d


def _as64(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.detach().to(device="cpu", dtype=torch.float64)
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def build_model(config: Dict, data: Dict):
    """Inducing grid, static kernel quantities and gradient-matched initial
    parameters, in float64 on the CPU.  Returns (static, params0).

    The generic (odeint-adjoint) potential the JAX driver also builds is
    ROADMAP queue 1 item 11; the fused path never calls it."""
    model = config.get("model", "gp")
    if model != "gp":
        raise NotImplementedError(
            f"model {model!r}: the port has the GP model only (ROADMAP "
            "queue 1 item 9 ports 'nn', 'spiral' and 'fhn')")
    Y, t = _as64(data["Y"]), _as64(data["t"])
    Z = kr.make_inducing_grid(Y, M=config["M"])
    static = kr.make_static(Z, sf=config["sf"], ell=config["ell"])
    params0 = kr.init_params(Y, t, static,
                             noise=config.get("noise", data["noise"]))
    return static, params0


def _poly_sched(config):
    return schedules.polynomial_decay(
        lr0=config["lr0"], gamma=config["lr_gamma"], t0=config["lr_t0"],
        alpha=config.get("lr_alpha", 1.0))


def _check_supported(config: Dict, make_plots: bool) -> None:
    if make_plots:
        raise NotImplementedError(
            "plots are not ported (ROADMAP queue 1 item 6); pass "
            "make_plots=False / --no-plots")
    if config.get("engine") != "fused":
        raise NotImplementedError(
            f"engine {config.get('engine')!r}: the port runs the fused "
            "engine only (the generic engine needs the ODE core and adjoint "
            "of ROADMAP queue 1 items 2 and 11)")
    solver = config.get("solver", "rk4")
    if solver != "dopri5":
        raise NotImplementedError(
            f"solver {solver!r}: the fused engine of the port has dopri5 "
            "only (ROADMAP queue 1 item 8 ports rk4)")
    if config["method"] not in ("SGLD", "pSGLD"):
        raise NotImplementedError(
            f"method {config['method']!r}: the port has SGLD and pSGLD "
            "(ROADMAP queue 1 items 8 and 12-14 port the others)")
    if int(config.get("ckpt_every") or 0) > 0:
        raise NotImplementedError(
            "checkpointed sampling (ckpt_every) is ROADMAP queue 1 item 6")


def run_sampler(config: Dict, data: Dict, output: str,
                make_plots: bool = True, device="cpu") -> Dict[str, Any]:
    """Posterior sampling of the GP-ODE model over a batch of chains on
    `device`.  The chain count is rounded up to a multiple of 128, as the
    JAX driver rounds it for its fused kernels.  Returns the summary dict
    (also logged to run.jsonl)."""
    _check_supported(config, make_plots)
    out_dir = _out_dir(output, config)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2, default=str)

    static, params0 = build_model(config, data)
    n_chains = config.get("num_chains", 64)
    n_chains = ((n_chains + 127) // 128) * 128
    f32 = torch.float32
    static32 = kr.GPVectorFieldStatic(
        Z=static.Z.to(device=device, dtype=f32),
        KzzinvL=static.KzzinvL.to(device=device, dtype=f32),
        Kzzinv=static.Kzzinv.to(device=device, dtype=f32),
        sf=static.sf, ell=static.ell)
    x0 = _as64(data["x0"]).to(device=device, dtype=f32)
    ts = _as64(data["t"]).to(device=device, dtype=f32)
    rtol, atol = config.get("rtol", 1e-7), config.get("atol", 1e-9)
    store_steps = config.get("store_steps", 128)
    pot_batch = make_fused_gp_potential_dopri5(
        static32, x0, ts, _as64(data["Y"]).to(device=device, dtype=f32),
        rtol=rtol, atol=atol, store_steps=store_steps)
    if config["method"] == "pSGLD":
        kernel = samplers.psgld_batched(pot_batch, _poly_sched(config),
                                        alpha=config["psgld_alpha"],
                                        lambda_=config["lambda_"])
    else:
        kernel = samplers.sgld_batched(pot_batch, _poly_sched(config))

    seed = config.get("seed", 0)
    jitter = config.get("jitter", 0.005)
    gen0 = torch.Generator(device=device).manual_seed(seed)
    pos0 = tree_map(
        lambda x: x.to(device=device, dtype=f32)[None]
        + jitter * torch.randn((n_chains,) + tuple(x.shape), generator=gen0,
                               device=device, dtype=f32),
        params0)
    # store_steps probe: one whole solve at the start positions shows
    # whether the recorded step mesh can hold the worst chain
    A0 = torch.einsum("mk,ckd->cmd", static32.KzzinvL, pos0["U"])
    _, probe = gp_dopri5_solve_whole(A0, x0, ts, static32, rtol=rtol,
                                     atol=atol)
    worst = int(probe["n_accepted"].max())
    if worst > store_steps:
        raise RuntimeError(f"store_steps={store_steps} is below the "
                           f"{worst} accepted steps of the worst start "
                           "position; raise config['store_steps']")
    state = kernel.init(pos0)
    total = config["num_samples"] // config["thinning"]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    _, positions, infos = samplers.sample_chain(
        kernel, state, gen, num_samples=total, burn_in=config["burn_in"],
        thin=config["thinning"])

    # (samples, C, ...) -> (C, samples, ...), the JAX driver's layout
    positions = tree_map(lambda x: x.transpose(0, 1), positions)
    pots = infos["potential"].transpose(0, 1).cpu().numpy()
    diag = positions["logsn"]                         # (C, samples, 2)
    if diag.shape[1] >= 4:
        ess_logsn = [float(samplers.ess(diag[:, :, d]))
                     for d in range(diag.shape[-1])]
        rhat_logsn = [float(samplers.split_rhat(diag[:, :, d]))
                      for d in range(diag.shape[-1])]
    else:
        ess_logsn = rhat_logsn = [float("nan")] * diag.shape[-1]
    summary = {
        "event": "summary", "method": config["method"],
        "num_chains": n_chains, "kept_samples": pots.shape[1],
        "min_potential": float(pots.min()),
        "median_potential": float(np.median(pots[:, -1])),
        "acceptance": float(infos["accepted"].float().mean()),
        "ess_logsn": ess_logsn, "rhat_logsn": rhat_logsn,
    }
    with RunLogger(os.path.join(out_dir, "run.jsonl")) as logger:
        logger.log(summary)
    save_pytree(os.path.join(out_dir, "chain.npz"), positions)
    np.save(os.path.join(out_dir, "total_loss_arr.npy"), pots)
    return summary


def worker(config: Dict, data: Dict, output: str, make_plots: bool = True,
           device="cpu") -> Dict[str, Any]:
    """Route by inf_type; the port runs the sampler only so far."""
    inf_type = config.get("inf_type", "sampler")
    if inf_type != "sampler":
        raise NotImplementedError(
            f"inf_type {inf_type!r}: ROADMAP queue 1 items 13 (optim) and "
            "14 (vi, evidence)")
    return run_sampler(config, data, output, make_plots=make_plots,
                       device=device)
