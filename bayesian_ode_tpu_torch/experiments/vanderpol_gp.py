"""GP-ODE experiment driver of the port.

Counterpart of `bayesian_ode_tpu/experiments/vanderpol_gp.py` for what the
port runs so far: engine="fused" with

  - model="gp", solver="dopri5": the whole adaptive solve and its discrete
    adjoint (kernels K2/K3, with a K1 store_steps probe);
  - model="gp", solver="rk4": the fixed-grid solve and its reverse sweep
    (kernels K4/K5);
  - model="nn" (the MLP field, H = config["hidden"], default 32) with
    solver="rk4" (kernels K6/K7) or "dopri5" (the MLP instance of K2/K3,
    store_steps 256 by default);
  - model="spiral" (the y^3-net field, H = config["hidden"], default 50)
    and model="fhn" (FitzHugh-Nagumo theta inference), solver="dopri5"
    only, as in the JAX driver (their K2/K3 instances, store_steps 128 by
    default);

under the methods SGLD, pSGLD, cSGLD, MALA and AdamSGLD.  Every chain
advances in one batch per sampler step: one fused forward and one fused
backward over all chains.  The entry points run on the card unless the
caller passes device="cpu".  The artifact layout follows the JAX driver:
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
from ..models import fhn_inference, mlp, spiral
from ..models import kernel_regression as kr
from ..ops.fhn_dopri5 import make_fused_fhn_potential_dopri5
from ..ops.gp_dopri5 import gp_dopri5_solve_whole
from ..ops.gp_dopri5_grad import make_fused_gp_potential_dopri5
from ..ops.gp_rk4 import make_fused_gp_potential
from ..ops.mlp_dopri5 import make_fused_mlp_potential_dopri5
from ..ops.mlp_rk4 import make_fused_mlp_potential
from ..ops.spiral_dopri5 import make_fused_spiral_potential_dopri5
from ..samplers import schedules
from ..utils.checkpoint import save_pytree
from ..utils.logging import RunLogger
from ..utils.pytree import tree_leaves, tree_map


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
    """The model's static quantities and initial parameters, in float64 on
    the CPU.  Returns (static, params0): for model="gp" the inducing grid's
    kernel quantities and the gradient-matched {'U', 'logsn'}; for
    model="nn" (the MLP mean-function baseline) None and the uniform
    (-0.5, 0.5) layer list of sizes [2, H, H, 2]; for model="spiral" None
    and the N(0, 0.1) y^3-net weights of H hidden units; for model="fhn"
    None and theta at the classic truth.  Random draws come from a
    generator seeded with config["seed"].

    The generic (odeint-adjoint) potential the JAX driver also builds is
    ROADMAP queue 1 item 11; the fused path never calls it."""
    model = config.get("model", "gp")
    gen = torch.Generator().manual_seed(config.get("seed", 0))
    if model == "nn":
        H = config.get("hidden", 32)
        return None, mlp.init_mlp(gen, [2, H, H, 2])
    if model == "spiral":
        return None, spiral.init_params(gen, hidden=config.get("hidden", 50))
    if model == "fhn":
        return None, fhn_inference.init_theta()
    if model != "gp":
        raise ValueError(f"unknown model {model!r}; expected 'gp', 'nn', "
                         "'spiral' or 'fhn'")
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


METHODS = ("SGLD", "pSGLD", "cSGLD", "MALA", "AdamSGLD")
MODELS = ("gp", "nn", "spiral", "fhn")
# the fused engine's record budget per model at dopri5: the JAX driver's
# defaults (its MLP steps grow as chains move toward data-fitting fields)
STORE_STEPS = {"gp": 128, "nn": 256, "spiral": 128, "fhn": 128}


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
    if solver not in ("dopri5", "rk4"):
        raise NotImplementedError(
            f"solver {solver!r}: the fused engine takes dopri5 and rk4, as "
            "the JAX driver's; other solvers run on the generic engine "
            "(ROADMAP queue 1 items 2 and 11)")
    model = config.get("model", "gp")
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; expected 'gp', 'nn', "
                         "'spiral' or 'fhn'")
    if model in ("spiral", "fhn") and solver != "dopri5":
        raise NotImplementedError(
            f"engine='fused' model={model!r} supports solver='dopri5' "
            f"only (got {solver!r}), as in the JAX driver: the field has no "
            "fixed-grid kernel")
    if config["method"] == "SVGD":
        raise NotImplementedError(
            "method 'SVGD': the JAX driver runs SVGD over the generic "
            "odeint-adjoint potential, which waits for ROADMAP queue 1 item "
            "11; the sampler itself is samplers.svgd / svgd_batched")
    if config["method"] not in METHODS:
        raise NotImplementedError(
            f"method {config['method']!r}: the port has {', '.join(METHODS)} "
            "(ROADMAP queue 1 items 13, 14 and 18 port the others)")
    if int(config.get("ckpt_every") or 0) > 0:
        raise NotImplementedError(
            "checkpointed sampling (ckpt_every) is ROADMAP queue 1 item 6")


def _make_potential(config: Dict, data: Dict, static, device):
    """The fused batch potential of the configured model and solver."""
    f32 = torch.float32
    x0 = _as64(data["x0"]).to(device=device, dtype=f32)
    ts = _as64(data["t"]).to(device=device, dtype=f32)
    Y = _as64(data["Y"]).to(device=device, dtype=f32)
    model = config.get("model", "gp")
    reg = config.get("reg", 0.5)
    if config.get("solver", "rk4") == "rk4":
        if model == "nn":
            return make_fused_mlp_potential(x0, ts, Y, reg=reg)
        return make_fused_gp_potential(static, x0, ts, Y)
    tol = {"rtol": config.get("rtol", 1e-7), "atol": config.get("atol", 1e-9),
           "store_steps": config.get("store_steps", STORE_STEPS[model])}
    if model == "nn":
        return make_fused_mlp_potential_dopri5(x0, ts, Y, reg=reg, **tol)
    if model == "spiral":
        return make_fused_spiral_potential_dopri5(x0, ts, Y, reg=reg, **tol)
    if model == "fhn":
        return make_fused_fhn_potential_dopri5(
            x0, ts, Y, noise=float(config.get("noise", data["noise"])), **tol)
    return make_fused_gp_potential_dopri5(static, x0, ts, Y, **tol)


def _make_kernel(config: Dict, pot_batch):
    """Method dispatch of the JAX driver's fused branch."""
    method = config["method"]
    if method == "pSGLD":
        return samplers.psgld_batched(pot_batch, _poly_sched(config),
                                      alpha=config["psgld_alpha"],
                                      lambda_=config["lambda_"])
    if method == "MALA":
        return samplers.mala_batched(pot_batch, config["lr"])
    if method == "AdamSGLD":
        return samplers.adam_sgld_batched(
            pot_batch, _poly_sched(config), a=config.get("adam_a", 1.0),
            lambda_=config["lambda_"])
    if method == "cSGLD":
        return samplers.csgld_batched(
            pot_batch, lr0=config["lr0"],
            num_cycles=config.get("num_cycles", 4),
            total_iters=config["burn_in"] + config["num_samples"],
            beta=config.get("beta", 0.25))
    return samplers.sgld_batched(pot_batch, _poly_sched(config))


def _probe_store_steps(config, static, pos0, data, device) -> None:
    """One whole dopri5 solve at the start positions shows whether the
    recorded step mesh can hold the worst chain."""
    f32 = torch.float32
    rtol, atol = config.get("rtol", 1e-7), config.get("atol", 1e-9)
    store_steps = config.get("store_steps", 128)
    A0 = torch.einsum("mk,ckd->cmd", static.KzzinvL, pos0["U"])
    _, probe = gp_dopri5_solve_whole(
        A0, _as64(data["x0"]).to(device=device, dtype=f32),
        _as64(data["t"]).to(device=device, dtype=f32), static, rtol=rtol,
        atol=atol)
    worst = int(probe["n_accepted"].max())
    if worst > store_steps:
        raise RuntimeError(f"store_steps={store_steps} is below the "
                           f"{worst} accepted steps of the worst start "
                           "position; raise config['store_steps']")


def run_sampler(config: Dict, data: Dict, output: str,
                make_plots: bool = True, device="cuda") -> Dict[str, Any]:
    """Posterior sampling over a batch of chains on `device` (the card
    unless the caller asks for the CPU).  The chain count is rounded up to
    a multiple of 128, as the JAX driver rounds it for its fused kernels.
    Returns the summary dict (also logged to run.jsonl)."""
    _check_supported(config, make_plots)
    out_dir = _out_dir(output, config)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2, default=str)

    static, params0 = build_model(config, data)
    n_chains = config.get("num_chains", 64)
    n_chains = ((n_chains + 127) // 128) * 128
    f32 = torch.float32
    if static is not None:
        static = kr.GPVectorFieldStatic(
            Z=static.Z.to(device=device, dtype=f32),
            KzzinvL=static.KzzinvL.to(device=device, dtype=f32),
            Kzzinv=static.Kzzinv.to(device=device, dtype=f32),
            sf=static.sf, ell=static.ell)
    kernel = _make_kernel(config,
                          _make_potential(config, data, static, device))

    seed = config.get("seed", 0)
    jitter = config.get("jitter", 0.005)
    gen0 = torch.Generator(device=device).manual_seed(seed)
    pos0 = tree_map(
        lambda x: x.to(device=device, dtype=f32)[None]
        + jitter * torch.randn((n_chains,) + tuple(x.shape), generator=gen0,
                               device=device, dtype=f32),
        params0)
    if static is not None and config.get("solver", "rk4") == "dopri5":
        _probe_store_steps(config, static, pos0, data, device)
    state = kernel.init(pos0)
    total = config["num_samples"] // config["thinning"]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    _, positions, infos = samplers.sample_chain(
        kernel, state, gen, num_samples=total, burn_in=config["burn_in"],
        thin=config["thinning"])

    # (samples, C, ...) -> (C, samples, ...), the JAX driver's layout
    positions = tree_map(lambda x: x.transpose(0, 1), positions)
    pots = infos["potential"].transpose(0, 1).cpu().numpy()
    if isinstance(positions, dict) and "logsn" in positions:
        diag = positions["logsn"]                     # (C, samples, 2)
    else:
        # nn, spiral and fhn models: the first two coordinates of the last
        # leaf (keys sorted), as the JAX driver takes them
        lead = tree_leaves(positions)[-1]
        diag = lead.reshape(lead.shape[0], lead.shape[1], -1)[:, :, :2]
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
           device="cuda") -> Dict[str, Any]:
    """Route by inf_type; the port runs the sampler only so far."""
    inf_type = config.get("inf_type", "sampler")
    if inf_type != "sampler":
        raise NotImplementedError(
            f"inf_type {inf_type!r}: ROADMAP queue 1 items 13 (optim) and "
            "14 (vi, evidence)")
    return run_sampler(config, data, output, make_plots=make_plots,
                       device=device)
