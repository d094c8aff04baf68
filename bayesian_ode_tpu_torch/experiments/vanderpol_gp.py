"""GP-ODE experiment driver of the port.

Counterpart of `bayesian_ode_tpu/experiments/vanderpol_gp.py`.  Two
engines, chosen as the JAX driver chooses them (config["engine"]):

engine="fused", for the methods the JAX driver runs fused (SGLD, pSGLD,
cSGLD, MALA, AdamSGLD, aSGHMC, acSGHMC, SGRHMC, BAOAB, HMC, AdaptiveHMC,
NUTS, AdaptiveNUTS, PT and Ensemble):

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
(`make_potential`) over the batched `odeint_adjoint` at any solver of
`ode.SOLVERS` (`make_generic_potential`; dopri5, tsit5 and adams take
config rtol/atol, the others the adjoint's defaults, as in the JAX
driver), under SGLD,
pSGLD, aSGLD, cSGLD, MALA, AdamSGLD, the SG-HMC family, HAMCMC (variant
by the method name's last digit, `hamcmc_batched` with every chain's own
L-BFGS memory), HMC, AdaptiveHMC, NUTS and AdaptiveNUTS (the batched
kernels, where the JAX driver vmaps the per-chain ones: the same steps
chain by chain), PT and Ensemble, or SVGD over its particles (K8 for
4,096 particles or more on the card).

With config["ckpt_every"] > 0 the chain runs in segments of that many
kept samples, each followed by an atomic checkpoint of the sampler state
and the samples so far (`_sample_chain_checkpointed`); config["resume"]
continues an interrupted run from it, to the same chain bit for bit.

method="SMC" (model="gp" only) runs adaptive tempered SMC from prior
draws on the normalized log-density split
(`kernel_regression.make_log_density_parts`) over the generic engine's
solve: the particles double as chains with one kept sample each, and
log Z lands in the summary.

`run_optim` (inf_type="optim") fits the MAP by L-BFGS or one of the
optax optimizers of the JAX driver, on the generic potential of one
chain.  `run_vi` (inf_type="vi") fits ADVI (mean-field or full-rank) or
the Laplace approximation on the generic batch potential and keeps
draws from it; `run_evidence` (inf_type="evidence") estimates the GP
model's log Z by TI and stepping stone, SMC, generalized stepping stone
and Laplace (float64 on the run's device), with WAIC and PSIS-LOO from
the SMC particles.

Every chain advances in one batch per sampler step.  The entry points run
on the card unless the caller passes device="cpu".  The artifact layout
follows the JAX driver: {output}/{method}/{id}{dir_name}/ with
config.json, run.jsonl (summary), chain.npz (map_params.npz for
run_optim) and total_loss_arr.npy (run_vi: variational.npz, and
elbo_arr.npy for ADVI; run_evidence: evidence.json and no
total_loss_arr.npy).
method="MMALA" raises the TypeError the JAX driver hits (its metric's
forward-mode Hessian cannot pass the adjoint's custom_vjp), and Laplace,
whose Hessian differentiates the adjoint's backward solve, raises
ValueError at the solvers with an accept/reject loop (and fixed_adams,
whose corrector loops), as in the JAX driver.

With make_plots=True (the default) each run also writes the JAX driver's
PDF files: run_sampler and run_vi post.pdf and phase_mode.pdf, and for
the GP model predictive_bands.pdf and logsn_hist.pdf; run_optim
post.pdf, post_log.pdf, phase_map.pdf and trajectories.pdf.  Their
numbers come from `sampler_plot_numbers` and `optim_plot_numbers` (on the
run's device, in float64); matplotlib is imported only to draw them, with
the Agg backend, and its ImportError reaches the caller where it is not
installed, as in the JAX driver.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from .. import samplers
from ..models import DYNAMICS, fhn_inference, mlp, spiral
from ..models import kernel_regression as kr
from ..models.kernel_regression import full_f32_matmul
from ..ode.adjoint import _LOOPED, odeint_adjoint
from ..ode import odeint
from ..ode.odeint import SOLVERS, check_method
from ..ops.fhn_dopri5 import make_fused_fhn_potential_dopri5
from ..ops.gp_dopri5 import gp_dopri5_solve_whole
from ..ops.gp_dopri5_grad import make_fused_gp_potential_dopri5
from ..ops.gp_rk4 import make_fused_gp_potential
from ..ops.mlp_dopri5 import make_fused_mlp_potential_dopri5
from ..ops.mlp_rk4 import make_fused_mlp_potential
from ..ops.spiral_dopri5 import make_fused_spiral_potential_dopri5
from ..optim import lbfgs_minimize
from ..samplers import schedules
from ..utils import checkpoint
from ..utils.checkpoint import save_pytree
from ..utils.logging import RunLogger
from ..utils.pytree import (
    ravel_pytree,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def _out_dir(output: str, config: Dict) -> str:
    d = os.path.join(output, str(config["method"]),
                     str(config.get("id", 0)) + config.get("dir_name", ""))
    os.makedirs(d, exist_ok=True)
    return d


def _write_config(output: str, config: Dict) -> str:
    """The run's directory, with config.json written into it."""
    out_dir = _out_dir(output, config)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2, default=str)
    return out_dir


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


# the methods the JAX driver runs on the fused engine (all ported)
FUSED_METHODS = ("SGLD", "cSGLD", "pSGLD", "AdamSGLD", "aSGHMC", "acSGHMC",
                 "SGRHMC", "MALA", "BAOAB", "HMC", "AdaptiveHMC", "NUTS",
                 "AdaptiveNUTS", "PT", "Ensemble")
EXACT_METHODS = ("HMC", "AdaptiveHMC", "NUTS", "AdaptiveNUTS", "PT",
                 "Ensemble")
GENERIC_METHODS = ("SGLD", "pSGLD", "aSGLD", "cSGLD", "MALA", "AdamSGLD",
                   "aSGHMC", "acSGHMC", "SGRHMC", "BAOAB") + EXACT_METHODS
GENERIC_SOLVERS = tuple(SOLVERS)
# the solvers that take config rtol/atol (the JAX driver's `_make_solve`)
ADAPTIVE_SOLVERS = ("dopri5", "tsit5", "adams")
MODELS = ("gp", "nn", "spiral", "fhn")
# the fused engine's record budget per model at dopri5: the JAX driver's
# defaults (its MLP steps grow as chains move toward data-fitting fields)
STORE_STEPS = {"gp": 128, "nn": 256, "spiral": 128, "fhn": 128}


def is_fused(config: Dict) -> bool:
    """Whether the JAX driver runs this config on its fused engine."""
    return (config.get("engine") == "fused"
            and config["method"] in FUSED_METHODS)


def _check_model(config: Dict) -> None:
    model = config.get("model", "gp")
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; expected 'gp', 'nn', "
                         "'spiral' or 'fhn'")


def _check_solver(config: Dict) -> None:
    check_method(config.get("solver", "rk4"))


def _check_second_order(config: Dict, what: str) -> None:
    """The Laplace Hessian differentiates the continuous adjoint's backward
    solve, which an adaptive solver's loop does not allow (ode/adjoint.py;
    the JAX driver's jacrev of grad raises there)."""
    solver = config.get("solver", "rk4")
    if solver in _LOOPED:
        raise ValueError(
            f"{what} needs a fixed-grid solver (got solver={solver!r}): its "
            "Hessian differentiates the adjoint's backward solve, and the "
            "JAX driver's jacrev of grad raises 'Reverse-mode "
            "differentiation does not work for lax.while_loop' there")


def _check_supported(config: Dict) -> None:
    _check_model(config)
    model = config.get("model", "gp")
    method = config["method"]
    if method == "MMALA":
        raise TypeError(
            "method 'MMALA' does not run in the JAX driver either: its "
            "metric's jax.hessian is jacfwd of jacrev and raises \"can't "
            "apply forward-mode autodiff (jvp) to a custom_vjp function\" "
            "on the adjoint's custom_vjp; samplers.mmala_batched runs on "
            "potentials with a reverse-over-reverse Hessian")
    if method == "SMC":
        if model != "gp":
            raise ValueError("method='SMC' supports the GP model (the "
                             "NN-architecture fields have no normalized "
                             "log-density split)")
        _check_solver(config)
        return
    if (method != "SVGD" and method not in GENERIC_METHODS
            and not method.startswith("HAMCMC")):
        raise ValueError(f"unknown sampler method {method!r}")
    solver = config.get("solver", "rk4")
    if not is_fused(config):
        _check_solver(config)
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
    `make_sampler`), over the batched kernels: aSGLD is pSGLD's kernel;
    HAMCMC's variant is the method name's last digit (1 without one); the
    adaptive methods adapt over the burn-in."""
    method = config["method"]
    total = config["burn_in"] + config["num_samples"]
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
            num_cycles=config.get("num_cycles", 4), total_iters=total,
            beta=config.get("beta", 0.25))
    if method == "aSGHMC":
        return samplers.asghmc_batched(
            pot_batch, config["lr"], burn_in_steps=config["burn_in"],
            mom_decay=config.get("mom_decay", 5e-2),
            lambda_=config["lambda_"])
    if method == "acSGHMC":
        return samplers.acsghmc_batched(
            pot_batch, lr0=config["lr0"],
            num_cycles=config.get("num_cycles", 4), total_iters=total,
            burn_in_steps=config["burn_in"], beta=config.get("beta", 0.25),
            mom_decay=config.get("mom_decay", 5e-2),
            lambda_=config["lambda_"])
    if method == "SGRHMC":
        return samplers.sgrhmc_batched(
            pot_batch, _poly_sched(config),
            friction=config.get("friction", 0.1), lambda_=config["lambda_"])
    if method == "BAOAB":
        return samplers.baoab_batched(
            pot_batch, config["lr"], friction=config.get("friction", 1.0),
            burn_in_steps=config["burn_in"], lambda_=config["lambda_"])
    if method == "HMC":
        return samplers.hmc_batched(
            pot_batch, config["lr"],
            num_leapfrog=config.get("num_leapfrog", 10),
            jitter=config.get("eps_jitter", 0.2))
    if method == "AdaptiveHMC":
        return samplers.adaptive_hmc_batched(
            pot_batch, num_adapt=config["burn_in"], step_size=config["lr"],
            num_leapfrog=config.get("num_leapfrog", 10),
            target_accept=config.get("target_accept", 0.8),
            jitter=config.get("eps_jitter", 0.2))
    if method == "NUTS":
        return samplers.nuts_batched(pot_batch, config["lr"],
                                     max_depth=config.get("max_depth", 10))
    if method == "AdaptiveNUTS":
        return samplers.adaptive_nuts_batched(
            pot_batch, num_adapt=config["burn_in"], step_size=config["lr"],
            max_depth=config.get("max_depth", 10),
            target_accept=config.get("target_accept", 0.8))
    if method == "PT":
        # the K-rung ladder multiplies the chain batch (K C rows, one
        # forward and backward pass a step); the recorded positions are
        # the cold batch's
        return samplers.parallel_tempering_batched(
            pot_batch, samplers.temperature_ladder(
                config.get("num_replicas", 4), config.get("beta_min", 0.1)),
            config["lr"], inner=config.get("pt_inner", "mala"),
            swap_every=config.get("swap_every", 1),
            num_leapfrog=config.get("num_leapfrog", 10))
    if method == "Ensemble":
        # gradient-free interacting walkers: the chains are the walkers
        return samplers.stretch_move(pot_batch,
                                     a=config.get("stretch_a", 2.0))
    if method.startswith("HAMCMC"):
        return samplers.hamcmc_batched(
            pot_batch, _poly_sched(config),
            memory=config.get("memory", 5),
            variant=int(method[-1]) if method[-1].isdigit() else 1,
            trust_reg=config.get("trust_reg", 1.0),
            H_gamma=config.get("H_gamma", 1.0))
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
    adaptive = solver in ADAPTIVE_SOLVERS
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
        static = _static_on(static, device, dtype)

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

    def on_stream(params):
        fp = field_params(params)
        C = tree_leaves(fp)[0].shape[0]
        traj = solve(lambda t, y: batched_field(fp, t, y),
                     x0.expand((C,) + tuple(x0.shape)), ts,
                     tuple(tree_leaves(fp)))
        return torch.func.vmap(per_chain)(params, traj.movedim(1, 0))

    def potential_batch(params):
        if not x0.is_cuda:
            return on_stream(params)
        if adaptive:
            full_f32_matmul()
        return _on_own_stream(on_stream, params, x0.device)

    return potential_batch


def _on_own_stream(fn, params, device):
    """fn(params) queued on a CUDA stream of its own (one of torch's pooled
    streams), where the caller is on the default one; its backward runs
    there too (autograd runs a node on its forward's stream), so the
    adaptive loops of the adjoint's forward and backward solves can
    replay their steps as CUDA graphs (`ode.cuda_graph`).  The caller's
    stream waits for the result."""
    caller = torch.cuda.current_stream(device)
    if caller != torch.cuda.default_stream(device):
        return fn(params)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        out = fn(params)
    caller.wait_stream(stream)
    out.record_stream(caller)
    return out


def _static_on(static, device, dtype):
    """The GP static quantities in `dtype` on `device`."""
    return kr.GPVectorFieldStatic(
        Z=static.Z.to(device=device, dtype=dtype),
        KzzinvL=static.KzzinvL.to(device=device, dtype=dtype),
        Kzzinv=static.Kzzinv.to(device=device, dtype=dtype),
        sf=static.sf, ell=static.ell)


def make_gp_log_density_parts(config: Dict, data: Dict, static, device,
                              dtype=torch.float32):
    """The GP model's normalized log-density split on the generic engine's
    solve (config solver, rtol, atol), in `dtype` on `device`, with the
    config's logsn prior (logsn_mu, default log(noise); logsn_sd, default
    1) as the JAX driver builds it for SMC and the evidence."""
    solve, adaptive = _make_solve(config)
    if adaptive and torch.device(device).type == "cuda":
        full_f32_matmul()
    return kr.make_log_density_parts(
        _static_on(static, device, dtype), _as64(data["x0"]),
        _as64(data["t"]), _as64(data["Y"]), solve,
        logsn_mu=config.get("logsn_mu"),
        logsn_sd=config.get("logsn_sd", 1.0),
        noise=float(config.get("noise", data["noise"])))


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


def _run_fused(config, data, static, params0, device, out_dir):
    """The fused engine: (positions, infos, n_chains), the chain count
    rounded up to a multiple of 128 as the JAX driver rounds it (of 256
    for Ensemble, whose half-sweeps evaluate half the walkers)."""
    mult = 256 if config["method"] == "Ensemble" else 128
    n_chains = config.get("num_chains", 64)
    n_chains = ((n_chains + mult - 1) // mult) * mult
    f32 = torch.float32
    if static is not None:
        static = _static_on(static, device, f32)
    kernel = _make_kernel(config,
                          _make_potential(config, data, static, device))
    pos0 = _start_positions(config, params0, n_chains, device, f32)
    if static is not None and config.get("solver", "rk4") == "dopri5":
        _probe_store_steps(config, static, pos0, data, device)
    return _sample(config, kernel, pos0, device, out_dir) + (n_chains,)


def _sample(config, kernel, pos0, device, out_dir):
    """`sample_chain` from pos0 with a generator seeded config["seed"] + 1,
    or with config["ckpt_every"] > 0 `_sample_chain_checkpointed` into
    out_dir/sampler_ckpt.npz; returns (positions, infos) as the sampler
    stacks them."""
    state = kernel.init(pos0)
    seed = config.get("seed", 0) + 1
    total = config["num_samples"] // config["thinning"]
    ckpt_every = int(config.get("ckpt_every") or 0)
    if ckpt_every > 0:
        _, positions, infos = _sample_chain_checkpointed(
            kernel, state, seed, device, total, config["burn_in"],
            config["thinning"], ckpt_every,
            os.path.join(out_dir, "sampler_ckpt.npz"),
            resume=bool(config.get("resume")))
        return positions, infos
    gen = torch.Generator(device=device).manual_seed(seed)
    _, positions, infos = samplers.sample_chain(
        kernel, state, gen, num_samples=total, burn_in=config["burn_in"],
        thin=config["thinning"])
    return positions, infos


def _seeded_generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of stream `stream` of `seed` (a checkpoint segment, or
    one of run_vi's and run_evidence's streams), seeded from (seed,
    stream) as the JAX driver folds an index into its key or splits it."""
    words = np.random.SeedSequence([seed, stream]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        int(words[0]) << 32 | int(words[1]))


def _sample_chain_checkpointed(kernel, state, seed, device, total, burn_in,
                               thin, ckpt_every, ckpt_path, resume=False):
    """Segmented `sample_chain` with an on-disk checkpoint after every
    `ckpt_every` kept samples (the JAX driver's elastic resume of long
    chains).

    Segment i draws from `_seeded_generator(seed, i)`, burn-in runs in
    segment 0 only, and the checkpoint, written atomically after each
    segment, holds the sampler state, the next segment's index and the
    positions and infos so far.  A run killed mid-chain and resumed with
    `resume=True` therefore gives exactly the chain of an uninterrupted
    run of this function (which differs from one `sample_chain` call's
    by construction: enable `ckpt_every` from the start of a run that
    may need resuming).  Returns (state, positions, infos)."""
    segs = [min(ckpt_every, total - s) for s in range(0, total, ckpt_every)]
    start, positions, infos = 0, None, None
    if resume and os.path.exists(ckpt_path):
        # the template's structure: one kept sample's
        _, pos_t, info_t = samplers.sample_chain(
            kernel, state, _seeded_generator(seed, 0, device), 1, 0, thin)
        blob = checkpoint.load_pytree(ckpt_path, {
            "state": state, "next_seg": 0, "positions": pos_t,
            "infos": info_t})
        state, start = blob["state"], int(blob["next_seg"])
        positions, infos = blob["positions"], blob["infos"]

    def cat(a, b):
        return tree_map(lambda x, y: torch.cat([x, y], dim=0), a, b)

    for i, n in enumerate(segs):
        if i < start:
            continue
        state, pos_i, info_i = samplers.sample_chain(
            kernel, state, _seeded_generator(seed, i, device), n,
            burn_in if i == 0 else 0, thin)
        positions = pos_i if positions is None else cat(positions, pos_i)
        infos = info_i if infos is None else cat(infos, info_i)
        checkpoint.save_pytree(ckpt_path, {
            "state": state, "next_seg": i + 1, "positions": positions,
            "infos": infos})
    return state, positions, infos


def _run_generic(config, data, static, params0, device, dtype, out_dir):
    """The generic engine: the batched kernels over the generic batch
    potential, every chain in one batch (the chain count is not rounded,
    as on the JAX driver's generic engine, but for Ensemble's even
    count)."""
    n_chains = config.get("num_chains", 64)
    if config["method"] == "Ensemble":
        n_chains += n_chains % 2
    pot = make_generic_potential(config, data, static, device, dtype)
    kernel = _make_kernel(config, pot)
    if config.get("guard_finite"):
        # divergent chains freeze on their last finite state instead of
        # poisoning the batch
        kernel = samplers.guard_finite_batched(kernel, n_chains)
    pos0 = _start_positions(config, params0, n_chains, device, dtype)
    return _sample(config, kernel, pos0, device, out_dir) + (n_chains,)


def _run_svgd(config, data, static, params0, device, dtype, out_dir):
    """SVGD over a particle ensemble on the generic batch potential
    (particles double as chains).  The per-step potential is the ensemble
    mean, broadcast per particle, as in the JAX driver."""
    n = config.get("num_chains", 64)
    pot = make_generic_potential(config, data, static, device, dtype)
    kernel = samplers.svgd_batched(pot,
                                   step_size=config.get("lr", config["lr0"]))
    pos0 = _start_positions(config, params0, n, device, dtype)
    flat, infos = _sample(config, kernel, pos0, device, out_dir)
    # (samples, n, P) flat particles -> leaves (samples, n, ...)
    unravel = ravel_pytree(tree_map(lambda x: x[0], pos0))[1]
    positions = unravel(flat)
    S = flat.shape[0]
    infos = {"potential": infos["potential"][:, None].expand(S, n),
             "accepted": torch.ones((S, n), dtype=torch.bool)}
    return positions, infos, n


def _run_smc(config, data, static, device, dtype):
    """Adaptive tempered SMC from prior draws (the JAX driver's SMC branch):
    the particles double as chains, recorded as one kept sample each; the
    potential is the normalized -(log_lik + log_prior); log Z rides in the
    infos.  Prior draws come from a generator seeded config["seed"], the
    SMC run from seed + 1."""
    n = config.get("num_chains", 64)
    parts = make_gp_log_density_parts(config, data, static, device, dtype)
    seed = config.get("seed", 0)
    particles0 = parts.sample_prior(
        torch.Generator(device=device).manual_seed(seed), n)
    res = samplers.smc(
        torch.Generator(device=device).manual_seed(seed + 1), parts.log_lik,
        parts.log_prior, particles0,
        num_moves=config.get("smc_moves", 5),
        target_ess=config.get("smc_target_ess", 0.5),
        max_stages=config.get("smc_max_stages", 100))
    with torch.no_grad():
        pots = -(res.log_lik + parts.log_prior(res.particles))
    infos = {"potential": pots[None], "accepted": torch.ones((1, n),
                                                             dtype=torch.bool),
             "log_z": res.log_z}
    return tree_map(lambda x: x[None], res.particles), infos, n


# ---- the plots (the JAX driver's _plots_sampler_nn, _plots_sampler and
# _plots_optim): their numbers on the run's device, then matplotlib ----

GRID_POINTS = 15        # the phase plots' quiver grid, 15 x 15
BAND_DRAWS = 64         # chain draws re-solved for the predictive bands


def _field_of(config: Dict, static, device, dtype):
    """(field(params, t, y), label) of the configured model."""
    model = config.get("model", "gp")
    if model == "fhn":
        return fhn_inference.vector_field, "FHN theta"
    if model == "spiral":
        return spiral.vector_field, "spiral y^3-net"
    if model == "nn":
        return mlp.mlp_vector_field, "MLP"
    st = _static_on(static, device, dtype)
    return (lambda p, t, y: kr.vector_field(p, st, t, y)), "GP"


def _field_on_grid(field, params, data, device, dtype):
    """The field at params on a 15 x 15 grid over the data's range padded
    by 0.5: (gx, gy, field (225, 2)) as numpy."""
    Y = _as64(data["Y"]).numpy().reshape(-1, 2)
    lo, hi = Y.min(0) - 0.5, Y.max(0) + 0.5
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], GRID_POINTS),
                         np.linspace(lo[1], hi[1], GRID_POINTS))
    pts = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], 1),
                          device=device, dtype=dtype)
    with torch.no_grad():
        f = field(params, 0.0, pts)
    return gx, gy, f.cpu().numpy()


def _params_on(params, device, dtype):
    return tree_map(lambda x: torch.as_tensor(x).to(device=device,
                                                    dtype=dtype), params)


def sampler_plot_numbers(config: Dict, data: Dict, static, positions, pots,
                         device="cuda") -> Dict:
    """The numbers the sampler plots draw, as numpy, computed in float64 on
    `device`: the posterior mode (the lowest of pots (C, S) over the
    positions (C, S, ...)), its field on the 15 x 15 grid ("grid_x",
    "grid_y", "field"), and for the GP model the posterior predictive
    bands: BAND_DRAWS chain draws picked by `RandomState(0)`, each solved
    by rk4 on 80 times to t=14 from 3 starts drawn by that RandomState
    ("band_t", "band_x0", "band_mean", "band_std": mean and standard
    deviation over the draws, (80, 3, 2)), beside the true dynamics' dopri5
    solve from those starts ("truth")."""
    dtype = torch.float64
    ci, si = np.unravel_index(np.argmin(pots), pots.shape)
    mode = _params_on(tree_map(lambda x: x[ci, si], positions), device,
                      dtype)
    field, _ = _field_of(config, static, device, dtype)
    gx, gy, f = _field_on_grid(field, mode, data, device, dtype)
    out = {"grid_x": gx, "grid_y": gy, "field": f}
    if static is None:
        return out
    st = _static_on(static, device, dtype)
    rng = np.random.RandomState(0)
    x0 = 2.0 * 1.0 * rng.uniform(size=(3, 2)) - 1.0
    t = np.linspace(0.0, 14.0, 80)
    n_draws = min(BAND_DRAWS, pots.size)
    U_all = torch.as_tensor(positions["U"])
    flat_U = U_all.reshape((-1,) + tuple(U_all.shape[2:]))
    idx = rng.choice(flat_U.shape[0], n_draws, replace=False)
    U = flat_U[torch.as_tensor(idx, device=flat_U.device)].to(device=device,
                                                              dtype=dtype)
    A = torch.matmul(st.KzzinvL, U)                       # (n, M, D)
    x0_t = torch.as_tensor(x0, device=device, dtype=dtype)
    t_t = torch.as_tensor(t, device=device, dtype=dtype)
    with torch.no_grad():
        # rk4 on the output times: the draws ride one state, each its own
        sols = odeint(lambda tt, X: kr.vector_field_fast(A, st, tt, X),
                      x0_t.expand((n_draws,) + x0.shape), t_t,
                      method="rk4")                       # (T, n, 3, 2)
        ode_fn = DYNAMICS[str(data.get("ODE", "vdp")).lower()]
        truth = odeint(ode_fn, x0_t, t_t, method="dopri5")
    sols = sols.movedim(1, 0).cpu().numpy()
    out.update(band_t=t, band_x0=x0, band_mean=sols.mean(0),
               band_std=sols.std(0), truth=truth.cpu().numpy())
    return out


def optim_plot_numbers(config: Dict, data: Dict, static, params,
                       device="cuda") -> Dict:
    """The numbers the MAP plots draw, as numpy, in float64 on `device`:
    the fitted field on the 15 x 15 grid ("grid_x", "grid_y", "field") and
    the fitted trajectories, rk4 on the observation times from the data's
    x0 ("fit", (T, N, 2)).  The JAX driver's `_plots_optim` reads the GP's
    static quantities for every model (and fails on the others); here each
    model draws its own field."""
    dtype = torch.float64
    params = _params_on(params, device, dtype)
    field, _ = _field_of(config, static, device, dtype)
    gx, gy, f = _field_on_grid(field, params, data, device, dtype)
    x0 = _as64(data["x0"]).to(device=device, dtype=dtype)
    t = _as64(data["t"]).to(device=device, dtype=dtype)
    if static is not None:
        st = _static_on(static, device, dtype)
        A = kr.precompute_weights(params, st)
        rhs = lambda tt, X: kr.vector_field_fast(A, st, tt, X)  # noqa: E731
    else:
        rhs = lambda tt, X: field(params, tt, X)  # noqa: E731
    with torch.no_grad():
        fit = odeint(rhs, x0, t, method="rk4")
    return {"grid_x": gx, "grid_y": gy, "field": f,
            "fit": fit.cpu().numpy()}


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plot_phase(plt, path, numbers, data, title):
    gx, f = numbers["grid_x"], numbers["field"]
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.quiver(gx, numbers["grid_y"], f[:, 0].reshape(gx.shape),
              f[:, 1].reshape(gx.shape), alpha=0.6)
    for traj in _as64(data["Y"]).numpy():
        ax.plot(traj[:, 0], traj[:, 1], ".", ms=2)
    ax.set_title(title)
    fig.savefig(path)
    plt.close(fig)


def _plot_losses(plt, path, losses, xlabel, ylabel, yscale="linear"):
    fig, ax = plt.subplots()
    ax.plot(losses)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_yscale(yscale)
    fig.savefig(path)
    plt.close(fig)


def _plots_sampler(out_dir, config, data, static, positions, pots, device):
    """Loss curve, posterior-mode phase plot with the learned field's
    quiver and, for the GP model, the predictive mean +/- 5 sigma bands and
    the logsn histogram (the JAX driver's `_plots_sampler_nn` and
    `_plots_sampler`, gp.py:383-507)."""
    numbers = sampler_plot_numbers(config, data, static, positions, pots,
                                   device)
    plt = _pyplot()
    _plot_losses(plt, os.path.join(out_dir, "post.pdf"),
                 np.median(pots, axis=0), "Kept sample",
                 "Negative log posterior (median over chains)")
    if static is None:
        _, label = _field_of(config, None, device, torch.float64)
        title = f"posterior mode {label} field ({config['method']})"
    else:
        title = f"posterior mode field ({config['method']})"
    _plot_phase(plt, os.path.join(out_dir, "phase_mode.pdf"), numbers, data,
                title)
    if static is None:
        return
    tn, mean, std = (numbers["band_t"], numbers["band_mean"],
                     numbers["band_std"])
    fig, axes = plt.subplots(ncols=3, figsize=(15, 3))
    for i in range(3):
        axes[i].plot(tn, numbers["truth"][:, i, 0], "-", color="r",
                     label="Position(real)")
        axes[i].fill_between(tn, mean[:, i, 0] - 5 * std[:, i, 0],
                             mean[:, i, 0] + 5 * std[:, i, 0], alpha=0.3)
        axes[i].plot(tn, mean[:, i, 0], "--", label="Position(mean)")
        axes[i].legend(fontsize=6)
    fig.savefig(os.path.join(out_dir, "predictive_bands.pdf"))
    plt.close(fig)
    fig, ax = plt.subplots()
    ax.hist(torch.as_tensor(positions["logsn"]).cpu().numpy().reshape(-1, 2),
            bins=30, label=["logsn_x", "logsn_y"])
    ax.legend()
    fig.savefig(os.path.join(out_dir, "logsn_hist.pdf"))
    plt.close(fig)


def _plots_optim(out_dir, config, data, static, params, losses, device):
    """MAP-run files (gp.py:200-287): loss curves (linear and log), the
    phase plot with the fitted field's quiver, fitted against observed
    trajectories."""
    numbers = optim_plot_numbers(config, data, static, params, device)
    plt = _pyplot()
    for name, yscale in [("post", "linear"), ("post_log", "log")]:
        _plot_losses(plt, os.path.join(out_dir, f"{name}.pdf"), losses,
                     "Iteration", "Negative log posterior", yscale)
    _plot_phase(plt, os.path.join(out_dir, "phase_map.pdf"), numbers, data,
                f"MAP field ({config['method']})")
    fit, tn = numbers["fit"], _as64(data["t"]).numpy()
    Y = _as64(data["Y"]).numpy()
    fig, axes = plt.subplots(ncols=min(3, fit.shape[1]), figsize=(12, 3))
    for i, ax in enumerate(np.atleast_1d(axes)):
        ax.plot(tn, Y[i, :, 0], ".", ms=3, label="obs x")
        ax.plot(tn, fit[:, i, 0], "-", label="fit x")
        ax.legend(fontsize=6)
    fig.savefig(os.path.join(out_dir, "trajectories.pdf"))
    plt.close(fig)


def run_sampler(config: Dict, data: Dict, output: str,
                make_plots: bool = True, device="cuda",
                dtype=torch.float32) -> Dict[str, Any]:
    """Posterior sampling over a batch of chains on `device` (the card
    unless the caller asks for the CPU).  The fused engine runs in float32
    with the chain count rounded up to a multiple of 128; the generic
    engine and SVGD run in `dtype` (float64 on the CPU where the JAX
    package runs under x64) with the chain count as given.  Returns the
    summary dict (also logged to run.jsonl)."""
    _check_supported(config)
    out_dir = _write_config(output, config)

    static, params0 = build_model(config, data)
    if is_fused(config):
        positions, infos, n_chains = _run_fused(config, data, static,
                                                params0, device, out_dir)
    elif config["method"] == "SVGD":
        positions, infos, n_chains = _run_svgd(config, data, static,
                                               params0, device, dtype,
                                               out_dir)
    elif config["method"] == "SMC":
        positions, infos, n_chains = _run_smc(config, data, static, device,
                                              dtype)
    else:
        positions, infos, n_chains = _run_generic(config, data, static,
                                                  params0, device, dtype,
                                                  out_dir)

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
        # population methods (SMC) keep one sample a particle: chain
        # autocorrelation diagnostics are undefined there
        ess_logsn = rhat_logsn = [float("nan")] * diag.shape[-1]
    summary = {
        "event": "summary", "method": config["method"],
        "num_chains": n_chains, "kept_samples": pots.shape[1],
        "min_potential": float(pots.min()),
        "median_potential": float(np.median(pots[:, -1])),
        "acceptance": float(infos["accepted"].float().mean()),
        "ess_logsn": ess_logsn, "rhat_logsn": rhat_logsn,
    }
    if "swap_accepted" in infos:
        summary["swap_acceptance"] = float(
            infos["swap_accepted"].float().mean())
    if "log_z" in infos:
        summary["log_z_smc"] = float(infos["log_z"])
    with RunLogger(os.path.join(out_dir, "run.jsonl")) as logger:
        logger.log(summary)
    save_pytree(os.path.join(out_dir, "chain.npz"), positions)
    np.save(os.path.join(out_dir, "total_loss_arr.npy"), pots)
    if make_plots:
        _plots_sampler(out_dir, config, data, static, positions, pots,
                       device)
    return summary


def _clip_by_global_norm(grads, max_norm):
    """optax.clip_by_global_norm: g unchanged below max_norm, else
    g / |g| * max_norm (torch's clip_grad_norm_ scales by
    max_norm / (|g| + 1e-6) instead)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    return [torch.where(norm < max_norm, g, g / norm * max_norm)
            for g in grads]


def _first_order(config: Dict, potential, x0, n_iters: int):
    """The JAX driver's optax optimizers at lr/(1 + lr_decay step), step
    from 0, on `potential` from x0: (final tree, (n_iters,) losses, each
    taken before its update).  torch.optim computes optax's Adam, SGD
    (with and without momentum or Nesterov) and Adadelta updates; optax's
    RMSprop (eps inside the square root) and its global-norm clip are
    written out here."""
    method, lr0 = config["method"], config["lr"]
    decay = config.get("lr_decay", 0.0)
    leaves = [x.detach().clone() for x in tree_leaves(x0)]
    x = tree_unflatten(x0, leaves)
    clip, rms, opt = None, None, None
    if method == "Adam":
        opt = torch.optim.Adam(leaves, lr=lr0, betas=(0.9, 0.999), eps=1e-8)
    elif "nag" in method:
        clip = config.get("clip", 10.0)
        opt = torch.optim.SGD(leaves, lr=lr0, momentum=0.5, nesterov=True)
    elif "SGD" in method:
        clip = config.get("clip", 10.0)
        opt = torch.optim.SGD(leaves, lr=lr0,
                              momentum=config.get("mom") or 0.0)
    elif "RMSprop" in method:
        alpha = config.get("rmsprop_alpha", 0.99)
        rms = [torch.zeros_like(p) for p in leaves]
    elif "Adadelta" in method:
        opt = torch.optim.Adadelta(leaves, lr=lr0,
                                   rho=config.get("adadelta_rho", 0.9),
                                   eps=1e-6)
    else:
        raise ValueError(f"unknown optimizer method {method!r}")

    vag = samplers.potential_and_grad(potential)
    losses = []
    for step in range(n_iters):
        lr = lr0 / (1 + decay * step) if decay else lr0
        value, grads = vag(x)
        losses.append(value)
        grads = tree_leaves(grads)
        if clip is not None:
            grads = _clip_by_global_norm(grads, clip)
        if rms is not None:
            with torch.no_grad():
                for p, g, nu in zip(leaves, grads, rms):
                    nu.copy_((1 - alpha) * g ** 2 + alpha * nu)
                    p.add_(torch.rsqrt(nu + 1e-8) * g, alpha=-lr)
            continue
        for p, g in zip(leaves, grads):
            p.grad = g
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    return x, torch.stack(losses)


def run_optim(config: Dict, data: Dict, output: str, make_plots: bool = True,
              device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """MAP optimization (the JAX driver's `run_optim`) on `device` in
    `dtype`: the generic engine's potential of one chain from the model's
    start point, minimized for config["num_iters"] iterations by L-BFGS
    (method containing "LBFGS": `lbfgs_minimize` with config line_search,
    default "armijo", history_size and lr; its loss trace is each
    iteration's value after the move) or by Adam, nag, SGD, RMSprop or
    Adadelta (`_first_order`, matched by name in that order).  Writes
    total_loss_arr.npy, map_params.npz and the run.jsonl summary; returns
    {"final_loss", "best_loss"}."""
    _check_model(config)
    _check_solver(config)
    out_dir = _write_config(output, config)

    static, params0 = build_model(config, data)
    pot_batch = make_generic_potential(config, data, static, device, dtype)

    def potential(p):
        return pot_batch(tree_map(lambda x: x[None], p))[0]

    x0 = tree_map(lambda x: x.to(device=device, dtype=dtype), params0)
    method, n_iters = config["method"], config["num_iters"]
    if "LBFGS" in method:
        x, value, losses, _ = lbfgs_minimize(
            potential, x0, max_iters=n_iters,
            line_search=config.get("line_search", "armijo"),
            history_size=config.get("history_size", 10), lr=config["lr"])
    else:
        x, losses = _first_order(config, potential, x0, n_iters)
        value = losses[-1]
    losses = losses.cpu().numpy()
    result = {"final_loss": float(value), "best_loss": float(np.min(losses))}
    np.save(os.path.join(out_dir, "total_loss_arr.npy"), losses)
    with RunLogger(os.path.join(out_dir, "run.jsonl")) as logger:
        logger.log({"event": "summary", "method": method, **result})
    save_pytree(os.path.join(out_dir, "map_params.npz"), x)
    if make_plots:
        _plots_optim(out_dir, config, data, static, x, losses, device)
    return result


def run_vi(config: Dict, data: Dict, output: str, make_plots: bool = True,
           device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Posterior approximation without MCMC (the JAX driver's `run_vi`) on
    the generic batch potential, in `dtype` on `device`: method "ADVI"
    (config vi_family "meanfield" or "fullrank", num_iters steps of
    elbo_samples draws, lr, init_scale, stl) or "Laplace" (L-BFGS for
    num_iters iterations at lr, then the Hessian at the mode; fixed-grid
    solvers only).  The fit and the draws take separate generators, seeded
    from (seed, 0) and (seed, 1), as the JAX driver splits its key.
    `chain.npz` holds num_samples draws as chains with one sample each;
    variational.npz the fit; returns the run.jsonl summary."""
    _check_model(config)
    _check_solver(config)
    method = config["method"]
    if method not in ("ADVI", "Laplace"):
        raise ValueError(f"unknown vi method {method!r}; "
                         "expected 'ADVI' or 'Laplace'")
    if method == "Laplace":
        _check_second_order(config, "method='Laplace'")
    out_dir = _write_config(output, config)

    static, params0 = build_model(config, data)
    pot_batch = make_generic_potential(config, data, static, device, dtype)
    x0 = tree_map(lambda x: x.to(device=device, dtype=dtype), params0)
    n_draws = config.get("num_samples", 1000)
    seed = config.get("seed", 0)
    fit_gen = _seeded_generator(seed, 0, device)
    draw_gen = _seeded_generator(seed, 1, device)
    if method == "ADVI":
        res = samplers.fit_advi(
            fit_gen, None, x0, num_steps=config.get("num_iters", 2000),
            sample_size=config.get("elbo_samples", 8),
            family=config.get("vi_family", "meanfield"),
            learning_rate=config.get("lr", 1e-2),
            init_scale=config.get("init_scale", 0.1),
            stl=bool(config.get("stl", False)), potential_batch=pot_batch)
        draws = samplers.sample_advi(res, draw_gen, n_draws)
        np.save(os.path.join(out_dir, "elbo_arr.npy"),
                res.elbo_trace.cpu().numpy())
        save_pytree(os.path.join(out_dir, "variational.npz"),
                    {"mu": res.mu, "scale_tril": res.scale_tril})
        fit_scalar = {"final_elbo": float(res.final_elbo)}
    else:
        res = samplers.laplace_approximation(
            pot_batch, x0, max_iters=config.get("num_iters", 200),
            lr=config.get("lr", 1.0))
        draws = samplers.sample_laplace(res, draw_gen, n_draws)
        save_pytree(os.path.join(out_dir, "variational.npz"),
                    {"mu": res.mu, "prec_chol": res.prec_chol})
        fit_scalar = {"log_evidence": float(res.log_evidence),
                      "potential_at_mode": float(res.potential_at_mode),
                      "hessian_pd": bool(res.hessian_pd)}

    # draws as chains: (n_draws, ...) -> (chains, samples=1, ...)
    positions = tree_map(lambda x: x[:, None], draws)
    with torch.no_grad():
        pots = pot_batch(draws)[:, None].cpu().numpy()
    summary = {"event": "summary", "method": method, "num_draws": n_draws,
               "min_potential": float(pots.min()),
               "median_potential": float(np.median(pots)), **fit_scalar}
    with RunLogger(os.path.join(out_dir, "run.jsonl")) as logger:
        logger.log(summary)
    save_pytree(os.path.join(out_dir, "chain.npz"), positions)
    np.save(os.path.join(out_dir, "total_loss_arr.npy"), pots)
    if make_plots:
        _plots_sampler(out_dir, config, data, static, positions, pots,
                       device)
    return summary


def _tolist(x):
    return x.detach().cpu().tolist()


def run_evidence(config: Dict, data: Dict, output: str,
                 make_plots: bool = True, device="cuda",
                 dtype=torch.float32) -> Dict[str, Any]:
    """Bayesian model comparison on the GP-ODE posterior (the JAX driver's
    `run_evidence`; config model is not read, as there): log Z of the
    normalized log-density split (`make_gp_log_density_parts`) by

      1. TI and stepping stone over a power ladder (`log_evidence`:
         num_rungs x num_chains rows from params0 jittered by `jitter`
         0.05, burn_in warm-up steps adapting each rung's MALA step from
         lr, then num_samples at thinning);
      2. `smc_repeats` SMC runs of smc_particles prior draws (their mean
         log Z, the repeats' spread as its SE);
      3. generalized stepping stone from the last SMC population;
      4. Laplace from the best SMC particle, in float64 on the run's own
         device (laplace_iters, laplace_lr), with the static quantities
         rebuilt in float64 (fixed-grid solvers only);
      5. WAIC and PSIS-LOO from that population's pointwise log-liks;
      6. `evidence_reliability`'s flags and rank_by.

    The rest runs in `dtype` on `device`.  Each stage draws from its own
    generator, seeded from (seed, stream).  Writes evidence.json (every
    estimate, SE and diagnostic), config.json, run.jsonl (the summary)
    and chain.npz (the SMC particles, one sample each); returns the
    summary."""
    _check_solver(config)
    _check_second_order(config, "inf_type='evidence' (its Laplace stage)")
    out_dir = _write_config(output, config)
    seed = config.get("seed", 0)
    static, params0 = build_model(dict(config, model="gp"), data)
    parts = make_gp_log_density_parts(config, data, static, device, dtype)
    gens = {name: _seeded_generator(seed, i, device) for i, name in
            enumerate(("init", "ladder", "gss"))}

    # --- TI + stepping stone over the power ladder
    C = config.get("num_chains", 32)
    jitter = config.get("jitter", 0.05)
    pos0 = tree_map(
        lambda x: x.to(device=device, dtype=dtype)[None] + jitter
        * torch.randn((C,) + tuple(x.shape), generator=gens["init"],
                      device=device, dtype=dtype), params0)
    ladder = dict(num_rungs=config.get("num_rungs", 16),
                  step_size=config.get("lr", 1e-3),
                  num_warmup=config.get("burn_in", 500),
                  num_samples=config.get("num_samples", 1000),
                  thin=config.get("thinning", 1), adapt_step=True)
    res = samplers.log_evidence(gens["ladder"], parts.log_lik,
                                parts.log_prior, pos0, **ladder)

    # --- adaptive tempered SMC: an independent estimate and the draws
    n_particles = config.get("smc_particles", 1024)
    n_repeats = config.get("smc_repeats", 2)
    smc_logz, smc_res = [], None
    for r in range(n_repeats):
        particles0 = parts.sample_prior(
            _seeded_generator(seed, 100 + r, device), n_particles)
        smc_res = samplers.smc(
            _seeded_generator(seed, 200 + r, device), parts.log_lik,
            parts.log_prior, particles0,
            num_moves=config.get("smc_moves", 5),
            target_ess=config.get("smc_target_ess", 0.5),
            max_stages=config.get("smc_max_stages", 100))
        smc_logz.append(float(smc_res.log_z))
    smc_mean = float(np.mean(smc_logz))
    smc_se = (float(np.std(smc_logz, ddof=1) / np.sqrt(n_repeats))
              if n_repeats > 1 else float("nan"))

    # --- generalized stepping stone from a Gaussian fitted to the SMC
    # particles: every rung in the data-fit regime, log Z absolute
    gss = samplers.log_evidence_gss(gens["gss"], parts.log_lik,
                                    parts.log_prior, smc_res.particles,
                                    num_chains=C, **ladder)

    # --- Laplace in float64 on this device from the best SMC particle
    # (the gradient-matching start can sit behind exploding-trajectory
    # cliffs): the Hessian's log-det needs eigenvalues below float32
    # resolution of a ~1000-nat potential
    f64 = torch.float64
    parts64 = make_gp_log_density_parts(config, data, static, device, f64)
    with torch.no_grad():
        best = int(torch.argmax(smc_res.log_lik
                                + parts.log_prior(smc_res.particles)))
    init64 = tree_map(lambda l: l[best].to(f64), smc_res.particles)
    lap = samplers.laplace_approximation(
        parts64.potential, init64,
        max_iters=config.get("laplace_iters", 200),
        lr=config.get("laplace_lr", 1.0))

    # --- predictive scores from the last SMC population
    with torch.no_grad():
        ll_matrix = parts.pointwise_log_lik(smc_res.particles)
    w = samplers.waic(ll_matrix)
    loo = samplers.psis_loo(ll_matrix)

    summary = {
        "event": "summary", "method": config["method"], "M": config["M"],
        "log_z_ti": float(res.log_z_ti), "ti_se": float(res.ti_se),
        "log_z_ss": float(res.log_z_ss), "ss_se": float(res.ss_se),
        "log_z_gss": float(gss.log_z_ss), "gss_se": float(gss.ss_se),
        "log_z_smc": smc_mean, "smc_se": smc_se,
        "log_z_laplace": float(lap.log_evidence),
        "laplace_hessian_pd": bool(lap.hessian_pd),
        "waic_elpd": float(w.elpd), "waic_se": float(w.se),
        "waic_p_eff": float(w.p_eff),
        "loo_elpd": float(loo.elpd), "loo_se": float(loo.se),
        "loo_max_khat": float(loo.pareto_k.max()),
    }
    rel = samplers.evidence_reliability(
        log_z_ti=summary["log_z_ti"], log_z_ss=summary["log_z_ss"],
        ss_se=summary["ss_se"], log_z_gss=summary["log_z_gss"],
        gss_se=summary["gss_se"], log_z_smc=smc_mean, smc_se=smc_se,
        log_z_laplace=summary["log_z_laplace"],
        laplace_hessian_pd=bool(lap.hessian_pd),
        waic_elpd=summary["waic_elpd"],
        ladder_nonfinite=int(res.num_nonfinite),
        gss_nonfinite=int(gss.num_nonfinite))
    summary["estimator_reliability"] = rel["estimators"]
    summary["rank_by"] = rel["rank_by"]
    detail = dict(summary)
    detail.update({
        "smc_log_z_repeats": smc_logz,
        "smc_num_stages": int(smc_res.num_stages),
        "ladder_nonfinite_draws": int(res.num_nonfinite),
        "gss_nonfinite_draws": int(gss.num_nonfinite),
        "gss_accept": _tolist(gss.accept_rate),
        "ladder_betas": _tolist(res.betas),
        "ladder_accept": _tolist(res.accept_rate),
        "ladder_steps": _tolist(res.step_sizes),
        "mean_log_lik": _tolist(res.mean_log_lik),
    })
    with open(os.path.join(out_dir, "evidence.json"), "w") as f:
        json.dump(detail, f, indent=2, default=str)
    with RunLogger(os.path.join(out_dir, "run.jsonl")) as logger:
        logger.log(summary)
    save_pytree(os.path.join(out_dir, "chain.npz"),
                tree_map(lambda x: x[:, None], smc_res.particles))
    return summary


def worker(config: Dict, data: Dict, output: str, make_plots: bool = True,
           device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Route by inf_type, as the JAX driver's worker: "optim" to
    `run_optim`, "vi" to `run_vi`, "evidence" to `run_evidence`, anything
    else to `run_sampler`, each on `device` in `dtype`."""
    route = {"optim": run_optim, "vi": run_vi,
             "evidence": run_evidence}.get(config.get("inf_type"),
                                           run_sampler)
    return route(config, data, output, make_plots=make_plots, device=device,
                 dtype=dtype)
