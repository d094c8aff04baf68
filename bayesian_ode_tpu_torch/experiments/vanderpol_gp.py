"""GP-ODE experiment driver of the port.

Counterpart of `bayesian_ode_tpu/experiments/vanderpol_gp.py`.  Two
engines, chosen as the JAX driver chooses them (config["engine"]):

engine="fused", for the methods the JAX driver runs fused (of them the
port has SGLD, pSGLD, cSGLD, MALA and AdamSGLD):

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

every other engine value, and every method the JAX driver does not run
fused, takes the generic engine: each model's per-chain potential
(`make_potential`) over the batched `odeint_adjoint` at solver dopri5,
tsit5, rk4, euler or midpoint (`make_generic_potential`), under SGLD,
pSGLD, aSGLD, cSGLD, MALA and AdamSGLD, or SVGD over its particles (K8
for 4,096 particles or more on the card).

Every chain advances in one batch per sampler step.  The entry points run
on the card unless the caller passes device="cpu".  The artifact layout
follows the JAX driver: {output}/{method}/{id}{dir_name}/ with
config.json, run.jsonl (summary), chain.npz and total_loss_arr.npy.
Every other method, solver or option raises NotImplementedError naming
the ROADMAP item that ports it.
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
from ..models.kernel_regression import full_f32_matmul
from ..ode.adjoint import odeint_adjoint
from ..ode.odeint import _check_method
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
from ..utils.pytree import ravel_pytree, tree_leaves, tree_map


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
    generator seeded with config["seed"].  `make_generic_potential` builds
    the generic engine's batch potential over them."""
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


# the methods the JAX driver runs on the fused engine, and those of them
# the port has
FUSED_METHODS = ("SGLD", "cSGLD", "pSGLD", "AdamSGLD", "aSGHMC", "acSGHMC",
                 "SGRHMC", "MALA", "BAOAB", "HMC", "AdaptiveHMC", "NUTS",
                 "AdaptiveNUTS", "PT", "Ensemble")
METHODS = ("SGLD", "pSGLD", "cSGLD", "MALA", "AdamSGLD")
GENERIC_METHODS = ("SGLD", "pSGLD", "aSGLD", "cSGLD", "MALA", "AdamSGLD")
GENERIC_SOLVERS = ("dopri5", "tsit5", "rk4", "euler", "midpoint")
# the JAX driver's other methods, by the ROADMAP queue 1 item that ports
# them
UNPORTED_METHODS = {"PT": 14, "Ensemble": 14, "HMC": 14, "AdaptiveHMC": 14,
                    "NUTS": 14, "AdaptiveNUTS": 14, "SMC": 14, "MMALA": 14,
                    "aSGHMC": 18, "acSGHMC": 18, "SGRHMC": 18, "BAOAB": 18}
MODELS = ("gp", "nn", "spiral", "fhn")
# the fused engine's record budget per model at dopri5: the JAX driver's
# defaults (its MLP steps grow as chains move toward data-fitting fields)
STORE_STEPS = {"gp": 128, "nn": 256, "spiral": 128, "fhn": 128}


def is_fused(config: Dict) -> bool:
    """Whether the JAX driver runs this config on its fused engine."""
    return (config.get("engine") == "fused"
            and config["method"] in FUSED_METHODS)


def _check_supported(config: Dict, make_plots: bool) -> None:
    if make_plots:
        raise NotImplementedError(
            "plots are not ported (ROADMAP queue 1 item 6); pass "
            "make_plots=False / --no-plots")
    model = config.get("model", "gp")
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; expected 'gp', 'nn', "
                         "'spiral' or 'fhn'")
    method = config["method"]
    if method.startswith("HAMCMC"):
        raise NotImplementedError(
            f"method {method!r}: HAMCMC and L-BFGS are ROADMAP queue 1 "
            "item 13")
    if method in UNPORTED_METHODS:
        raise NotImplementedError(
            f"method {method!r} is not ported (ROADMAP queue 1 item "
            f"{UNPORTED_METHODS[method]})")
    if method != "SVGD" and method not in GENERIC_METHODS:
        raise ValueError(f"unknown sampler method {method!r}")
    if int(config.get("ckpt_every") or 0) > 0:
        raise NotImplementedError(
            "checkpointed sampling (ckpt_every) is ROADMAP queue 1 item 6")
    solver = config.get("solver", "rk4")
    if not is_fused(config):
        if solver not in GENERIC_SOLVERS:
            _check_method(solver)          # item 16, or unknown
        return
    if solver not in ("dopri5", "rk4"):
        raise ValueError(
            f"engine='fused' supports solver 'rk4' or 'dopri5' (got "
            f"{solver!r}); use the generic engine for others")
    if model in ("spiral", "fhn") and solver != "dopri5":
        raise NotImplementedError(
            f"engine='fused' model={model!r} supports solver='dopri5' "
            f"only (got {solver!r}), as in the JAX driver: the field has no "
            "fixed-grid kernel")


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
    """Method dispatch of the JAX driver (its fused branch and
    `make_sampler`), over the batched kernels: aSGLD is pSGLD's kernel."""
    method = config["method"]
    if method in ("pSGLD", "aSGLD"):
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

def _make_solve(config: Dict):
    """(solve, adaptive): the generic engine's solver dispatch, the JAX
    driver's `_make_solve` over a chain batch.  solve(field, x0, ts,
    params) integrates field(t (C,), y (C, N, 2)) with the batched
    `odeint_adjoint` (gradients to x0, ts and the per-chain `params`).
    Adaptive solvers take config rtol/atol (defaults 1e-7/1e-9), the
    others the adjoint's defaults, as in the JAX driver."""
    solver = config.get("solver", "rk4")
    adaptive = solver in ("dopri5", "tsit5")
    tol = ({"rtol": config.get("rtol", 1e-7),
            "atol": config.get("atol", 1e-9)} if adaptive else {})

    def solve(field, x0, ts, params):
        return odeint_adjoint(field, x0, ts, method=solver,
                              adjoint_params=params, batched=True, **tol)

    return solve, adaptive


def make_generic_potential(config: Dict, data: Dict, static, device,
                           dtype=torch.float32):
    """The generic engine's batch potential: params (leaves with a leading
    chain axis C) -> (C,) potentials.

    The JAX driver vmaps a per-chain potential whose solve is a while
    loop; here the solve is batched instead.  The model's vector field
    runs per chain through `torch.func.vmap`, one `odeint_adjoint` solves
    every chain with its own step sizes, and each chain's potential is
    the model's own `make_potential` (vmapped over the chains) on that
    chain's trajectory, so it equals the per-chain definition chain by
    chain.  `static` is the GP model's (None for the others); data and
    parameters are taken in `dtype` on `device`."""
    model = config.get("model", "gp")
    solve, adaptive = _make_solve(config)
    x0 = _as64(data["x0"]).to(device=device, dtype=dtype)
    ts = _as64(data["t"]).to(device=device, dtype=dtype)
    Y = _as64(data["Y"]).to(device=device, dtype=dtype)
    reg = config.get("reg", 0.5)
    if model == "gp":
        static = kr.GPVectorFieldStatic(
            Z=static.Z.to(device=device, dtype=dtype),
            KzzinvL=static.KzzinvL.to(device=device, dtype=dtype),
            Kzzinv=static.Kzzinv.to(device=device, dtype=dtype),
            sf=static.sf, ell=static.ell)

        def field_params(params):
            return torch.matmul(static.KzzinvL, params["U"])

        def field(A, t, y):
            return kr.vector_field_fast(A, static, t, y)

        def potential(odeint_fn):
            return kr.make_potential(static, x0, ts, Y, odeint_fn)
    else:
        def field_params(params):
            return params

        field = {"nn": mlp.mlp_vector_field, "spiral": spiral.vector_field,
                 "fhn": fhn_inference.vector_field}[model]
        if model == "nn":
            def potential(odeint_fn):
                return mlp.make_potential(x0, ts, Y, odeint_fn, reg=reg)
        elif model == "spiral":
            def potential(odeint_fn):
                return spiral.make_potential(x0, ts, Y, odeint_fn, reg=reg)
        else:
            noise = float(config.get("noise", data["noise"]))

            def potential(odeint_fn):
                return fhn_inference.make_potential(x0, ts, Y, odeint_fn,
                                                    noise=noise)
    batched_field = torch.func.vmap(field)

    def per_chain(params, traj):
        return potential(lambda f, x0_, ts_: traj)(params)

    def potential_batch(params):
        if adaptive and x0.is_cuda:
            full_f32_matmul()
        fp = field_params(params)
        C = tree_leaves(fp)[0].shape[0]
        traj = solve(lambda t, y: batched_field(fp, t, y),
                     x0.expand((C,) + tuple(x0.shape)), ts,
                     tuple(tree_leaves(fp)))
        return torch.func.vmap(per_chain)(params, traj.movedim(1, 0))

    return potential_batch


def _start_positions(config: Dict, params0, n_chains: int, device, dtype):
    """params0 broadcast over the chains plus N(0, jitter^2) per leaf from
    a generator seeded with config["seed"]."""
    jitter = config.get("jitter", 0.005)
    gen0 = torch.Generator(device=device).manual_seed(config.get("seed", 0))
    return tree_map(
        lambda x: x.to(device=device, dtype=dtype)[None]
        + jitter * torch.randn((n_chains,) + tuple(x.shape), generator=gen0,
                               device=device, dtype=dtype),
        params0)


def _run_fused(config, data, static, params0, device):
    """The fused engine: (positions, infos, n_chains), the chain count
    rounded up to a multiple of 128 as the JAX driver rounds it."""
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
    pos0 = _start_positions(config, params0, n_chains, device, f32)
    if static is not None and config.get("solver", "rk4") == "dopri5":
        _probe_store_steps(config, static, pos0, data, device)
    return _sample(config, kernel, pos0, device) + (n_chains,)


def _sample(config, kernel, pos0, device):
    """`sample_chain` from pos0 with a generator seeded config["seed"] + 1;
    returns (positions, infos) as the sampler stacks them."""
    state = kernel.init(pos0)
    gen = torch.Generator(device=device).manual_seed(
        config.get("seed", 0) + 1)
    _, positions, infos = samplers.sample_chain(
        kernel, state, gen, num_samples=config["num_samples"]
        // config["thinning"], burn_in=config["burn_in"],
        thin=config["thinning"])
    return positions, infos


def _run_generic(config, data, static, params0, device, dtype):
    """The generic engine: the batched kernels over the generic batch
    potential, every chain in one batch (the chain count is not rounded,
    as on the JAX driver's generic engine)."""
    n_chains = config.get("num_chains", 64)
    pot = make_generic_potential(config, data, static, device, dtype)
    kernel = _make_kernel(config, pot)
    if config.get("guard_finite"):
        # divergent chains freeze on their last finite state instead of
        # poisoning the batch
        kernel = samplers.guard_finite_batched(kernel, n_chains)
    pos0 = _start_positions(config, params0, n_chains, device, dtype)
    return _sample(config, kernel, pos0, device) + (n_chains,)


def _run_svgd(config, data, static, params0, device, dtype):
    """SVGD over a particle ensemble on the generic batch potential
    (particles double as chains).  The per-step potential is the ensemble
    mean, broadcast per particle, as in the JAX driver."""
    n = config.get("num_chains", 64)
    pot = make_generic_potential(config, data, static, device, dtype)
    kernel = samplers.svgd_batched(pot,
                                   step_size=config.get("lr", config["lr0"]))
    pos0 = _start_positions(config, params0, n, device, dtype)
    flat, infos = _sample(config, kernel, pos0, device)
    # (samples, n, P) flat particles -> leaves (samples, n, ...)
    unravel = ravel_pytree(tree_map(lambda x: x[0], pos0))[1]
    positions = unravel(flat)
    S = flat.shape[0]
    infos = {"potential": infos["potential"][:, None].expand(S, n),
             "accepted": torch.ones((S, n), dtype=torch.bool)}
    return positions, infos, n


def run_sampler(config: Dict, data: Dict, output: str,
                make_plots: bool = True, device="cuda",
                dtype=torch.float32) -> Dict[str, Any]:
    """Posterior sampling over a batch of chains on `device` (the card
    unless the caller asks for the CPU).  The fused engine runs in float32
    with the chain count rounded up to a multiple of 128; the generic
    engine and SVGD run in `dtype` (float64 on the CPU where the JAX
    package runs under x64) with the chain count as given.  Returns the
    summary dict (also logged to run.jsonl)."""
    _check_supported(config, make_plots)
    out_dir = _out_dir(output, config)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2, default=str)

    static, params0 = build_model(config, data)
    if is_fused(config):
        positions, infos, n_chains = _run_fused(config, data, static,
                                                params0, device)
    elif config["method"] == "SVGD":
        positions, infos, n_chains = _run_svgd(config, data, static,
                                               params0, device, dtype)
    else:
        positions, infos, n_chains = _run_generic(config, data, static,
                                                  params0, device, dtype)

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
