"""Langevin samplers: SGLD, pSGLD, aSGLD, cSGLD, Adam-SGLD, MALA and
manifold MALA.

Counterpart of `bayesian_ode_tpu/samplers/langevin.py`.  The `*_batched`
kernels take the
batch-potential contract: `potential_batch(params)` maps a tree of
tensors with a leading chain axis C to (C,) potentials in one fused
forward and backward pass.  The state carries the potential and gradient
at the current position, so a step costs exactly one pass, and
`info["potential"]` is the pre-step value (MALA: the post-step value).
Positions are updated out of place: each step's position is kept by
`sample_chain`.  Noise is drawn from the generator leaf by leaf; MALA then
draws one uniform per chain.  The single-chain kernels (`sgld`, `psgld`,
`asgld`, `csgld`, `mala`, `adam_sgld`) take a potential of one chain's
position and are the batched kernels over a one-chain batch, their states
the batched states without the chain axis.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..utils.pytree import (
    ravel_pytree,
    tree_leaves,
    tree_map,
    tree_random_normal,
    tree_sum_squares_per_chain,
)
from . import schedules
from .base import TransitionKernel, batch_value_and_grad, langevin_noise_scale


class BatchLangevinState(NamedTuple):
    position: Any           # tree of tensors with a leading chain axis C
    potential: torch.Tensor  # (C,)
    grad: Any
    step: int


class BatchPreconditionedState(NamedTuple):
    position: Any
    potential: torch.Tensor
    grad: Any
    v: Any                  # EMA of squared gradients
    step: int


class AdamSGLDState(NamedTuple):
    position: Any
    potential: torch.Tensor
    grad: Any
    m: Any
    v: Any
    step: int


def sgld_batched(potential_batch: Callable, step_size,
                 add_noise: bool = True) -> TransitionKernel:
    """SGLD over a whole chain batch per step:
    theta' = theta - lr * grad - sqrt(2 lr) * xi (no xi with
    add_noise=False, for deterministic equivalence tests)."""
    sched = schedules.resolve(step_size)
    vag = batch_value_and_grad(potential_batch)

    def init(position):
        u, g = vag(position)
        return BatchLangevinState(position, u, g, 0)

    def step(generator, state):
        lr = sched(state.step)
        if add_noise:
            noise = tree_random_normal(generator, state.position)
            scale = langevin_noise_scale(lr)
            new_pos = tree_map(lambda p, g, n: p - lr * g - scale * n,
                               state.position, state.grad, noise)
        else:
            new_pos = tree_map(lambda p, g: p - lr * g, state.position,
                               state.grad)
        u, g = vag(new_pos)
        info = {"potential": state.potential, "accepted": True,
                "step_size": lr}
        return BatchLangevinState(new_pos, u, g, state.step + 1), info

    return TransitionKernel(init, step)


def _where_per_chain(accept, a, b):
    """Leafwise where with a (C,) predicate broadcast over trailing axes."""
    return tree_map(
        lambda x, y: torch.where(
            accept.reshape(accept.shape + (1,) * (x.dim() - 1)), x, y), a, b)


def mala_batched(potential_batch: Callable, step_size, precond=None,
                 add_noise: bool = True) -> TransitionKernel:
    """MALA over a whole chain batch per step: the SGLD proposal with a
    per-chain Metropolis-Hastings correction (asymmetric-proposal ratio,
    reference langevin.py:69-91), at the cost of one fused forward and
    backward pass per step.  Each chain accepts on its own uniform.

    `precond`: an optional FIXED diagonal metric G (a tree matching the
    position, leaves broadcastable), e.g. `psgld_preconditioner` of a
    pSGLD warm-up: proposal p - lr G g - sqrt(2 lr G) xi and the
    G-weighted ratio |.|^2 / (4 lr G).  add_noise=False takes the plain
    gradient step with no correction (deterministic equivalence tests)."""
    sched = schedules.resolve(step_size)
    vag = batch_value_and_grad(potential_batch)
    plain = sgld_batched(potential_batch, step_size, add_noise=False)

    def init(position):
        u, g = vag(position)
        return BatchLangevinState(position, u, g, 0)

    def step(generator, state):
        if not add_noise:
            return plain.step(generator, state)
        lr = sched(state.step)
        G = precond if precond is not None else tree_map(
            torch.ones_like, state.position)
        noise = tree_random_normal(generator, state.position)
        scale = langevin_noise_scale(lr)
        proposal = tree_map(
            lambda p, g, G_, n: p - lr * G_ * g - scale * torch.sqrt(G_) * n,
            state.position, state.grad, G, noise)
        u_new, g_new = vag(proposal)

        def weighted_sq(tree):
            return tree_sum_squares_per_chain(tree_map(
                lambda x, G_: x / torch.sqrt(G_.expand(x.shape)), tree, G))

        log_alpha = state.potential - u_new                       # (C,)
        rev = tree_map(lambda po, pn, G_, gn: po - pn + lr * G_ * gn,
                       state.position, proposal, G, g_new)
        log_alpha = log_alpha + -1.0 / (4 * lr) * weighted_sq(rev)
        fwd = tree_map(lambda pn, po, G_, go: pn - po + lr * G_ * go,
                       proposal, state.position, G, state.grad)
        log_alpha = log_alpha - -1.0 / (4 * lr) * weighted_sq(fwd)
        uniform = torch.rand(log_alpha.shape, generator=generator,
                             dtype=log_alpha.dtype, device=log_alpha.device)
        accept = torch.isfinite(log_alpha) & (torch.log(uniform) < log_alpha)
        new_state = BatchLangevinState(
            position=_where_per_chain(accept, proposal, state.position),
            potential=torch.where(accept, u_new, state.potential),
            grad=_where_per_chain(accept, g_new, state.grad),
            step=state.step + 1)
        info = {"potential": new_state.potential, "accepted": accept,
                "step_size": lr}
        return new_state, info

    return TransitionKernel(init, step)


def csgld_batched(potential_batch: Callable, lr0: float, num_cycles: int,
                  total_iters: int, beta: float = 0.25,
                  add_noise: bool = True) -> TransitionKernel:
    """Cyclical SGLD over a whole chain batch per step (reference
    langevin.py:1600-1724): cosine step size over `num_cycles` cycles,
    pure gradient steps in the exploration phase (r <= beta), Langevin
    noise in the sampling phase.  info["sampling_phase"] marks
    posterior-sample steps.  `add_noise=False` exists for deterministic
    equivalence tests only."""
    vag = batch_value_and_grad(potential_batch)
    lr_fn = schedules.cyclical_cosine(lr0, num_cycles, total_iters)

    def init(position):
        u, g = vag(position)
        return BatchLangevinState(position, u, g, 0)

    def step(generator, state):
        lr = lr_fn(state.step)
        r = schedules.cycle_position(state.step, num_cycles, total_iters)
        in_sampling = r > beta
        noise = tree_random_normal(generator, state.position)
        scale = (langevin_noise_scale(lr) if in_sampling and add_noise
                 else 0.0)
        new_pos = tree_map(lambda p, g, n: p - lr * g - scale * n,
                           state.position, state.grad, noise)
        u, g = vag(new_pos)
        info = {"potential": state.potential, "accepted": True,
                "step_size": lr, "sampling_phase": in_sampling}
        return BatchLangevinState(new_pos, u, g, state.step + 1), info

    return TransitionKernel(init, step)


def psgld_preconditioner(state, lambda_: float = 1e-5,
                         chain_average: bool = True):
    """Fixed diagonal metric G = 1 / (lambda + sqrt(V)) from a pSGLD
    warm-up state, to pass as `precond` to `mala_batched` (a fixed metric
    keeps the chains exactly reversible).  `chain_average` averages G over
    the leading chain axis so every chain shares one metric."""
    G = tree_map(lambda v: 1.0 / (lambda_ + torch.sqrt(v)), state.v)
    if chain_average:
        G = tree_map(lambda g: g.mean(dim=0, keepdim=True).expand(g.shape),
                     G)
    return G


def psgld_batched(potential_batch: Callable, step_size, alpha: float = 0.99,
                  lambda_: float = 1e-5, add_noise: bool = True
                  ) -> TransitionKernel:
    """Preconditioned SGLD over a whole chain batch per step:
    V <- alpha V + (1 - alpha) g^2;  G = 1 / (lambda + sqrt(V));
    theta' = theta - lr G g - sqrt(2 lr G) xi  (reference langevin.py:478-497).
    `add_noise=False` exists for deterministic equivalence tests."""
    sched = schedules.resolve(step_size)
    vag = batch_value_and_grad(potential_batch)

    def init(position):
        u, g = vag(position)
        return BatchPreconditionedState(position, u, g,
                                        tree_map(torch.zeros_like, g), 0)

    def step(generator, state):
        lr = sched(state.step)
        v = tree_map(lambda v_, g_: alpha * v_ + (1 - alpha) * g_ ** 2,
                     state.v, state.grad)
        G = tree_map(lambda v_: 1.0 / (lambda_ + torch.sqrt(v_)), v)
        if add_noise:
            noise = tree_random_normal(generator, state.position)
            scale = langevin_noise_scale(lr)
            new_pos = tree_map(
                lambda p, g_, G_, n: p - lr * G_ * g_
                - scale * torch.sqrt(G_) * n,
                state.position, state.grad, G, noise)
        else:
            new_pos = tree_map(lambda p, g_, G_: p - lr * G_ * g_,
                               state.position, state.grad, G)
        u, g = vag(new_pos)
        info = {"potential": state.potential, "accepted": True,
                "step_size": lr}
        return (BatchPreconditionedState(new_pos, u, g, v, state.step + 1),
                info)

    return TransitionKernel(init, step)


def adam_sgld_batched(potential_batch: Callable, step_size,
                      beta1: float = 0.9, beta2: float = 0.999,
                      a: float = 1.0, lambda_: float = 1e-8
                      ) -> TransitionKernel:
    """Adam-preconditioned SGLD over a whole chain batch per step:

        m <- beta1 m + (1 - beta1) g;  V <- beta2 V + (1 - beta2) g^2
        G = 1 / (lambda + sqrt(V_hat))
        theta <- theta - lr G (g + a m_hat) - sqrt(2 lr G) xi

    The bias corrections 1 - beta^t are taken in float32, as the JAX
    package takes them."""
    sched = schedules.resolve(step_size)
    vag = batch_value_and_grad(potential_batch)

    def init(position):
        u, g = vag(position)
        z = tree_map(torch.zeros_like, g)
        return AdamSGLDState(position, u, g, z, z, 0)

    def step(generator, state):
        lr = sched(state.step)
        t = state.step + 1
        m = tree_map(lambda m_, g_: beta1 * m_ + (1 - beta1) * g_,
                     state.m, state.grad)
        v = tree_map(lambda v_, g_: beta2 * v_ + (1 - beta2) * g_ ** 2,
                     state.v, state.grad)
        tf = torch.tensor(float(t), dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(beta1, dtype=torch.float32) ** tf)
        bc2 = float(1.0 - torch.tensor(beta2, dtype=torch.float32) ** tf)
        noise = tree_random_normal(generator, state.position)
        scale = langevin_noise_scale(lr)
        new_pos = tree_map(
            lambda p, g_, m_, v_, n: p
            - lr * (g_ + a * m_ / bc1) / (lambda_ + torch.sqrt(v_ / bc2))
            - scale * torch.sqrt(1.0 / (lambda_ + torch.sqrt(v_ / bc2))) * n,
            state.position, state.grad, m, v, noise)
        u, g = vag(new_pos)
        info = {"potential": state.potential, "accepted": True,
                "step_size": lr}
        return AdamSGLDState(new_pos, u, g, m, v, t), info

    return TransitionKernel(init, step)


class MMALAState(NamedTuple):
    position: Any
    potential: torch.Tensor      # (C,)
    grad: Any
    metric: torch.Tensor         # (C, P, P) on the flattened parameters
    inv_metric: torch.Tensor     # (C, P, P)
    sqrtinv_metric: torch.Tensor  # (C, P, P)
    logdet_metric: torch.Tensor  # (C,)
    step: int


def mmala_batched(potential_batch: Callable, step_size, metric_fn: Callable,
                  add_noise: bool = True) -> TransitionKernel:
    """Manifold MALA (Girolami & Calderhead; reference langevin.py:260-420)
    over a whole chain batch, a metric for each chain.

    `metric_fn(position) -> dict` gives 'Metric', 'invMetric' and
    'sqrtinvMetric' (C, P, P) on each chain's flattened parameters (and
    optionally 'log_det_sqrt' (C,)): a metric of `metrics.py` over the
    batch potential.  Proposal theta' = theta - lr Minv g
    - sqrt(2 lr) Msqinv xi, so q(theta' | theta) = N(theta - lr Minv g,
    2 lr Minv); the Metropolis-Hastings ratio weights the quadratic forms
    by the metric and keeps the 1/2 log det M terms (the JAX package's
    fix of the reference's langevin.py:348-358).  Each chain accepts on
    its own uniform; add_noise=False accepts every proposal, as the JAX
    package's (deterministic equivalence tests)."""
    sched = schedules.resolve(step_size)
    vag = batch_value_and_grad(potential_batch)

    def eval_metric(position):
        m = metric_fn(position)
        if "log_det_sqrt" in m:
            logdet = 2.0 * m["log_det_sqrt"]
        else:
            logdet = torch.linalg.slogdet(m["Metric"])[1]
        return m["Metric"], m["invMetric"], m["sqrtinvMetric"], logdet

    def flat(tree):
        return torch.cat([x.reshape(x.shape[0], -1)
                          for x in tree_leaves(tree)], dim=1)

    def init(position):
        u, g = vag(position)
        return MMALAState(position, u, g, *eval_metric(position), 0)

    def step(generator, state):
        lr = sched(state.step)
        _, unravel = ravel_pytree(tree_map(lambda x: x[0], state.position))
        theta, grad = flat(state.position), flat(state.grad)      # (C, P)

        def mv(M, v):
            return (M @ v[..., None])[..., 0]

        xi = torch.randn(theta.shape, generator=generator,
                         dtype=theta.dtype, device=theta.device)
        theta_new = (theta - lr * mv(state.inv_metric, grad)
                     - langevin_noise_scale(lr)
                     * mv(state.sqrtinv_metric, xi))
        proposal = unravel(theta_new)
        u_new, g_new = vag(proposal)
        grad_new = flat(g_new)
        M_new, Minv_new, Msqinv_new, logdet_new = eval_metric(proposal)

        if add_noise:
            log_alpha = state.potential - u_new
            # log q(theta | theta'): metric and drift at the proposal
            rev = theta - theta_new + lr * mv(Minv_new, grad_new)
            log_alpha = log_alpha + 0.5 * logdet_new - 1.0 / (4 * lr) \
                * (rev * mv(M_new, rev)).sum(dim=-1)
            # log q(theta' | theta): metric and drift at the current point
            fwd = theta_new - theta + lr * mv(state.inv_metric, grad)
            log_alpha = log_alpha - (
                0.5 * state.logdet_metric - 1.0 / (4 * lr)
                * (fwd * mv(state.metric, fwd)).sum(dim=-1))
            uniform = torch.rand(log_alpha.shape, generator=generator,
                                 dtype=log_alpha.dtype,
                                 device=log_alpha.device)
            accept = torch.isfinite(log_alpha) & (
                torch.log(uniform) < log_alpha)
        else:
            accept = torch.ones(theta.shape[0], dtype=torch.bool,
                                device=theta.device)

        def pick(new, old):
            return _where_per_chain(accept, new, old)

        new_state = MMALAState(
            position=pick(proposal, state.position),
            potential=torch.where(accept, u_new, state.potential),
            grad=pick(g_new, state.grad),
            metric=pick(M_new, state.metric),
            inv_metric=pick(Minv_new, state.inv_metric),
            sqrtinv_metric=pick(Msqinv_new, state.sqrtinv_metric),
            logdet_metric=torch.where(accept, logdet_new,
                                      state.logdet_metric),
            step=state.step + 1)
        info = {"potential": new_state.potential, "accepted": accept,
                "step_size": lr}
        return new_state, info

    return TransitionKernel(init, step)


# ---------------------------------------------------------------------------
# single-chain kernels: the batched kernels over a one-chain batch
# ---------------------------------------------------------------------------

def _map_state(fn, state):
    """fn over every tensor of a kernel state (Python counters kept)."""
    def leaf(x):
        return fn(x) if torch.is_tensor(x) else x

    return type(state)(*(tree_map(leaf, f) for f in state))


def _one_chain(make_batched: Callable, potential_fn: Callable, *args,
               **kwargs) -> TransitionKernel:
    def potential_batch(p):
        return potential_fn(tree_map(lambda x: x[0], p)).reshape(1)

    batched = make_batched(potential_batch, *args, **kwargs)

    def init(position):
        state = batched.init(tree_map(lambda x: x.unsqueeze(0), position))
        return _map_state(lambda x: x[0], state)

    def step(generator, state):
        new, info = batched.step(
            generator, _map_state(lambda x: x.unsqueeze(0), state))
        info = {k: v[0] if torch.is_tensor(v) and v.dim() else v
                for k, v in info.items()}
        return _map_state(lambda x: x[0], new), info

    return TransitionKernel(init, step)


def sgld(potential_fn: Callable, step_size, add_noise: bool = True
         ) -> TransitionKernel:
    """SGLD (Welling & Teh 2011) of one chain: `sgld_batched`'s rule."""
    return _one_chain(sgld_batched, potential_fn, step_size,
                      add_noise=add_noise)


def mala(potential_fn: Callable, step_size, add_noise: bool = True
         ) -> TransitionKernel:
    """MALA of one chain: `mala_batched`'s proposal and correction."""
    return _one_chain(mala_batched, potential_fn, step_size,
                      add_noise=add_noise)


def psgld(potential_fn: Callable, step_size, alpha: float = 0.99,
          lambda_: float = 1e-5, add_noise: bool = True) -> TransitionKernel:
    """Preconditioned SGLD (Li et al. 2015) of one chain."""
    return _one_chain(psgld_batched, potential_fn, step_size, alpha=alpha,
                      lambda_=lambda_, add_noise=add_noise)


def asgld(potential_fn: Callable, step_size, alpha: float = 0.99,
          lambda_: float = 1e-5, add_noise: bool = True) -> TransitionKernel:
    """The reference's aSGLD, whose update is pSGLD's: the same kernel
    under its own name."""
    return psgld(potential_fn, step_size, alpha, lambda_, add_noise)


def csgld(potential_fn: Callable, lr0: float, num_cycles: int,
          total_iters: int, beta: float = 0.25,
          add_noise: bool = True) -> TransitionKernel:
    """Cyclical SGLD (Zhang et al. 2020) of one chain."""
    return _one_chain(csgld_batched, potential_fn, lr0, num_cycles,
                      total_iters, beta=beta, add_noise=add_noise)


def adam_sgld(potential_fn: Callable, step_size, beta1: float = 0.9,
              beta2: float = 0.999, a: float = 1.0, lambda_: float = 1e-8
              ) -> TransitionKernel:
    """Adam-preconditioned SGLD of one chain."""
    return _one_chain(adam_sgld_batched, potential_fn, step_size,
                      beta1=beta1, beta2=beta2, a=a, lambda_=lambda_)


def mmala(potential_fn: Callable, step_size, metric_fn: Callable,
          add_noise: bool = True) -> TransitionKernel:
    """Manifold MALA of one chain: `mmala_batched` over a batch of one.
    `metric_fn(position)` gives one chain's (P, P) 'Metric', 'invMetric'
    and 'sqrtinvMetric' (and optionally its 'log_det_sqrt'), as the JAX
    package's `mmala` takes it."""
    def batch_metric(position):
        m = metric_fn(tree_map(lambda x: x[0], position))
        return {k: torch.as_tensor(v).unsqueeze(0) for k, v in m.items()}

    return _one_chain(mmala_batched, potential_fn, step_size, batch_metric,
                      add_noise=add_noise)
