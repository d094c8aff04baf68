"""HAMCMC: L-BFGS-preconditioned Langevin dynamics (Simsekli et al. 2016,
arXiv:1602.03442), four window variants.

Counterpart of `bayesian_ode_tpu/samplers/hamcmc.py`.  The memory is
fixed-shape ring buffers (oldest first) in the kernel state, and the
factor recursions unroll over the M-1 pair slots with validity masks.
With B = C C^T (Hessian approximation) and H = B^{-1} = S S^T, each
curvature pair (s, y) updates

    C_+ = (I - u v^T) C,  u = Bs + sqrt(s^T B s / s^T y) y,  v = s / s^T B s
    S_+ = (I - p q^T) S,  p = s / s^T y,  q = y - sqrt(s^T y / s^T B s) Bs

and the dense BFGS update is kept as the test oracle
(`hamcmc_dense_oracle`).  The products take vectors (P,) or a batch
(..., P), with masks (n_pairs,) or (..., n_pairs): every dot is per
batch entry, `(a * b).sum(-1, keepdim=True)`.

Window variants (proposal base / curvature pairs):
  1: propose from theta_{t-M}; pairs s_i = theta_{i+M} - theta_i over a
     2M-1 window
  2: propose from theta_{t-M}; pairs from the newest two entries
  3: propose from theta_{t-1}; pairs lagged one step
  4: propose from theta_{t-1}; pairs from the newest two

A pair is kept iff s^T y > pair_eps s^T s, with y damped by trust_reg s.
Plain SGLD runs for the first warmup_extra + K steps while the memory
fills.  Every proposal is accepted unless accept_reject=True adds the
paper's Metropolis correction (see `hamcmc_batched`).

`hamcmc_batched` runs every chain of a batch in one step over the
batch-potential contract (`sgld_batched`'s): each chain keeps its own
(C, K, P) position and gradient buffers and (C, M-1, P) pairs, flattened
per chain with the chain axis kept, and its own pair masks and Metropolis
test; the step counter and the fill count are shared host integers, so
choosing between the warm-up and the metric step reads nothing from the
device.  `hamcmc` is the batched kernel over a one-chain batch.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..utils.pytree import ravel_pytree, tree_leaves, tree_map
from . import schedules
from .base import TransitionKernel, batch_value_and_grad, langevin_noise_scale
from .langevin import _one_chain


class HAMCMCState(NamedTuple):
    position: Any
    potential: torch.Tensor  # (C,)
    grad: Any
    params_buf: torch.Tensor  # (C, K, P) past positions, oldest first
    grads_buf: torch.Tensor   # (C, K, P)
    pots_buf: torch.Tensor    # (C, K) potentials at the stored positions
    s_buf: torch.Tensor       # (C, M-1, P) curvature pairs, oldest first
    y_buf: torch.Tensor       # (C, M-1, P)
    pair_valid: torch.Tensor  # (C, M-1) bool
    filled: int               # number of valid buffer rows (every chain)
    step: int


def _dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def _build_factors(s_buf, y_buf, valid, b0):
    """The (u, v, p, q) rank-one factors from the stored pairs; invalid
    slots give zero factors (identity operations)."""
    c0 = math.sqrt(b0)
    us, vs, ps, qs = [], [], [], []

    def B_(z):
        return _C_apply(_CT_apply(z, us, vs, c0), us, vs, c0)

    for i in range(s_buf.shape[-2]):
        s, y = s_buf[..., i, :], y_buf[..., i, :]
        sTy = _dot(s, y)
        ok = valid[..., i, None] & (sTy > 0)
        Bs = B_(s)
        sTBs = _dot(s, Bs)
        safe_sTy = torch.where(ok, sTy, 1.0)
        safe_sTBs = torch.where(ok, sTBs, 1.0)
        ratio = torch.sqrt(torch.clamp(safe_sTBs / safe_sTy, min=0.0))
        zero = torch.zeros_like(s)
        us.append(torch.where(ok, Bs + ratio * y, zero))
        vs.append(torch.where(ok, s / safe_sTBs, zero))
        ps.append(torch.where(ok, s / safe_sTy, zero))
        qs.append(torch.where(ok, y - (1.0 / ratio) * Bs, zero))
    return us, vs, ps, qs


def _S_apply(z, ps, qs, s0):
    """S z = (I - p_k q_k^T)...(I - p_1 q_1^T) S0 z."""
    w = s0 * z
    for p, q in zip(ps, qs):
        w = w - p * _dot(q, w)
    return w


def _ST_apply(z, ps, qs, s0):
    w = z
    for p, q in zip(reversed(ps), reversed(qs)):
        w = w - q * _dot(p, w)
    return s0 * w


def _C_apply(z, us, vs, c0):
    w = c0 * z
    for u, v in zip(us, vs):
        w = w - u * _dot(v, w)
    return w


def _CT_apply(z, us, vs, c0):
    w = z
    for u, v in zip(reversed(us), reversed(vs)):
        w = w - v * _dot(u, w)
    return c0 * w


def hamcmc_products(s_buf, y_buf, valid, H_gamma, grad_vec, noise_vec):
    """(H @ grad, S @ noise) with H = S S^T the L-BFGS inverse-Hessian
    approximation from the stored pairs and B0 = (1/H_gamma) I."""
    b0 = 1.0 / H_gamma
    s0 = 1.0 / math.sqrt(b0)
    _, _, ps, qs = _build_factors(s_buf, y_buf, valid, b0)
    Hg = _S_apply(_ST_apply(grad_vec, ps, qs, s0), ps, qs, s0)
    Sn = _S_apply(noise_vec, ps, qs, s0)
    return Hg, Sn


def hamcmc_B_product(s_buf, y_buf, valid, H_gamma, z):
    """B @ z = H^{-1} @ z through the C factors (the Metropolis test's
    quadratic forms)."""
    b0 = 1.0 / H_gamma
    c0 = math.sqrt(b0)
    us, vs, _, _ = _build_factors(s_buf, y_buf, valid, b0)
    return _C_apply(_CT_apply(z, us, vs, c0), us, vs, c0)


def hamcmc_dense_oracle(s_buf, y_buf, valid, H_gamma):
    """The dense BFGS inverse Hessian from the same pairs (the test oracle;
    the reference's `_compute_vector_prod_old`): (..., P, P)."""
    P = s_buf.shape[-1]
    eye = torch.eye(P, dtype=s_buf.dtype, device=s_buf.device)
    H = (H_gamma * eye).expand(s_buf.shape[:-2] + (P, P))
    for i in range(s_buf.shape[-2]):
        s, y = s_buf[..., i, :], y_buf[..., i, :]
        sTy = _dot(s, y)[..., None]
        ok = valid[..., i, None, None] & (sTy > 0)
        rho = 1.0 / torch.where(ok, sTy, 1.0)
        E = eye - rho * (s[..., :, None] * y[..., None, :])
        H_new = E @ H @ E.transpose(-1, -2) + rho * (s[..., :, None]
                                                     * s[..., None, :])
        H = torch.where(ok, H_new, H)
    return H


def _shift_in(buf, row):
    """Append `row` (C, ...) as the newest entry of `buf` (C, n, ...)."""
    return torch.cat([buf[:, 1:], row[:, None]], dim=1)


def hamcmc_batched(potential_batch: Callable, step_size, memory: int = 5,
                   variant: int = 1, trust_reg: float = 1.0,
                   H_gamma: float = 1.0, pair_eps: float = 1e-8,
                   warmup_extra: int = 100, add_noise: bool = True,
                   accept_reject: bool = False) -> TransitionKernel:
    """HAMCMC over a whole chain batch per step.  `memory` is the
    reference's (M = memory + 1); `variant` in {1, 2, 3, 4} picks the
    window scheme.

    accept_reject=True adds the Metropolis correction of the HAMCMC paper
    (Alg. 1) outside the warm-up: with proposal
    theta* ~ N(base - lr H grad(base), 2 lr H),
    log alpha = U(base) - U(theta*)
              - 1/(4 lr) (base - theta* + lr H g*)^T B (.)
              + 1/(4 lr) (theta* - base + lr H g_base)^T B (.)
    with B = H^{-1} applied matrix-free; each chain accepts on its own
    uniform, and a rejected chain restarts from its base entry.  It costs
    one more gradient evaluation a step."""
    if variant not in (1, 2, 3, 4):
        raise ValueError("variant must be 1..4")
    sched = schedules.resolve(step_size)
    vag = batch_value_and_grad(potential_batch)
    M = memory + 1
    K = 2 * M - 1 if variant == 1 else M
    n_pairs = M - 1
    warmup_steps = warmup_extra + K
    base_index = M - 1 if variant == 1 else (0 if variant == 2 else K - 1)

    def flat(tree):
        return torch.cat([x.reshape(x.shape[0], -1)
                          for x in tree_leaves(tree)], dim=1)

    def unravel(vec, like):
        return ravel_pytree(tree_map(lambda x: x[0], like))[1](vec)

    def init(position):
        u, g = vag(position)
        vec = flat(position)
        C, P = vec.shape

        def zeros(*shape, dtype=vec.dtype):
            return torch.zeros((C,) + shape, dtype=dtype, device=vec.device)

        return HAMCMCState(position, u, g, zeros(K, P), zeros(K, P),
                           zeros(K), zeros(n_pairs, P), zeros(n_pairs, P),
                           zeros(n_pairs, dtype=torch.bool), 0, 0)

    def pair_from(params_buf, grads_buf):
        """The variant's newest curvature pair, from the buffers after
        this step's append."""
        if variant == 1:
            s = params_buf[:, -1] - params_buf[:, M - 1]
            gdiff = grads_buf[:, -1] - grads_buf[:, M - 1]
        elif variant in (2, 4):
            s = params_buf[:, -1] - params_buf[:, -2]
            gdiff = grads_buf[:, -1] - grads_buf[:, -2]
        else:
            s = params_buf[:, -2] - params_buf[:, -3]
            gdiff = grads_buf[:, -2] - grads_buf[:, -3]
        return s, gdiff + trust_reg * s

    def step(generator, state):
        lr = sched(state.step)
        vec, grad_vec = flat(state.position), flat(state.grad)
        in_warmup = state.step < warmup_steps
        xi = (torch.randn(vec.shape, generator=generator, dtype=vec.dtype,
                          device=vec.device) if add_noise else None)

        # record the current aligned (position, gradient, potential)
        params_buf = _shift_in(state.params_buf, vec)
        grads_buf = _shift_in(state.grads_buf, grad_vec)
        pots_buf = _shift_in(state.pots_buf,
                             state.potential.to(vec.dtype))
        filled = min(state.filled + 1, K)

        accepted = torch.ones(vec.shape[0], dtype=torch.bool,
                              device=vec.device)
        if in_warmup:
            # plain SGLD on the flat vectors
            new_vec = vec - lr * grad_vec
            if add_noise:
                new_vec = new_vec - langevin_noise_scale(lr) * xi
        else:
            # the metric step from the variant's base entry
            base = params_buf[:, base_index]
            base_grad = grads_buf[:, base_index]
            Hg, Sn = hamcmc_products(
                state.s_buf, state.y_buf, state.pair_valid, H_gamma,
                base_grad, xi if add_noise else torch.zeros_like(vec))
            new_vec = base - lr * Hg
            if add_noise:
                new_vec = new_vec - langevin_noise_scale(lr) * Sn
            if accept_reject:
                u_prop, g_prop = vag(unravel(new_vec, state.position))
                Hg_prop, _ = hamcmc_products(
                    state.s_buf, state.y_buf, state.pair_valid, H_gamma,
                    flat(g_prop), torch.zeros_like(vec))
                fwd = new_vec - base + lr * Hg
                rev = base - new_vec + lr * Hg_prop
                Bfwd = hamcmc_B_product(state.s_buf, state.y_buf,
                                        state.pair_valid, H_gamma, fwd)
                Brev = hamcmc_B_product(state.s_buf, state.y_buf,
                                        state.pair_valid, H_gamma, rev)
                log_alpha = (pots_buf[:, base_index] - u_prop
                             - 1.0 / (4 * lr) * _dot(rev, Brev)[:, 0]
                             + 1.0 / (4 * lr) * _dot(fwd, Bfwd)[:, 0])
                uniform = torch.rand(log_alpha.shape, generator=generator,
                                     dtype=log_alpha.dtype,
                                     device=log_alpha.device)
                accepted = (torch.isfinite(log_alpha)
                            & (torch.log(uniform) < log_alpha))
                new_vec = torch.where(accepted[:, None], new_vec, base)

        s, y = pair_from(params_buf, grads_buf)
        pair_ok = (filled >= K) & (_dot(s, y) > pair_eps * _dot(s, s))
        s_buf = torch.where(pair_ok[:, :, None],
                            _shift_in(state.s_buf, s), state.s_buf)
        y_buf = torch.where(pair_ok[:, :, None],
                            _shift_in(state.y_buf, y), state.y_buf)
        pair_valid = torch.where(
            pair_ok,
            _shift_in(state.pair_valid, torch.ones_like(pair_ok[:, 0])),
            state.pair_valid)

        position = unravel(new_vec, state.position)
        u, g = vag(position)
        new_state = HAMCMCState(position, u, g, params_buf, grads_buf,
                                pots_buf, s_buf, y_buf, pair_valid, filled,
                                state.step + 1)
        info = {"potential": u, "accepted": accepted, "step_size": lr,
                "using_metric": not in_warmup,
                "n_pairs": pair_valid.sum(-1)}
        return new_state, info

    return TransitionKernel(init, step)


def hamcmc(potential_fn: Callable, step_size, memory: int = 5,
           variant: int = 1, trust_reg: float = 1.0, H_gamma: float = 1.0,
           pair_eps: float = 1e-8, warmup_extra: int = 100,
           add_noise: bool = True,
           accept_reject: bool = False) -> TransitionKernel:
    """HAMCMC of one chain: `hamcmc_batched` over a one-chain batch, its
    state the batched state without the chain axis."""
    return _one_chain(hamcmc_batched, potential_fn, step_size,
                      memory=memory, variant=variant, trust_reg=trust_reg,
                      H_gamma=H_gamma, pair_eps=pair_eps,
                      warmup_extra=warmup_extra, add_noise=add_noise,
                      accept_reject=accept_reject)
