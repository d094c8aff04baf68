"""Replica-exchange MCMC (parallel tempering) over the batch axis.

Counterpart of `bayesian_ode_tpu/samplers/tempering.py`.  A temperature
ladder is a batch axis: K replicas of every chain run the batched kernels
on the tempered potential beta_k U, on row-major replica rows (row = k C
+ c for K temperatures and C chains), so one forward and backward pass a
step covers every replica of every chain.  Replica k takes step
lr / beta_k (MALA, through `mala_batched`'s diagonal metric) or eps /
sqrt(beta_k) (HMC): hot, flat targets take bigger moves.  Swaps follow the
deterministic even/odd pairing: round r pairs (i, i + 1) for i = r mod 2,
accepted with probability min(1, exp((beta_i - beta_j)(U_i - U_j))) on
the unit-temperature potentials; an accepted swap exchanges the positions
and rescales the cached tempered potential and gradient by beta_i /
beta_j (both are linear in beta, so nothing is evaluated again).  Only
the cold replica (beta = 1) is the recorded `state.position`.

The ladder is float32, as in the JAX package, and cast into the
potential's dtype where it meets it.  The step counter is a host integer,
so whether a step swaps, and its parity, are chosen on the host; a step
that does not swap draws no uniforms.  The ladder as a mesh axis, one
temperature a shard, is `parallel.run_parallel_tempering_sharded`.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..utils.pytree import tree_leaves, tree_map
from .base import TransitionKernel
from .hamiltonian import hmc_batched
from .langevin import mala_batched

__all__ = ["parallel_tempering", "parallel_tempering_batched",
           "temperature_ladder"]


def temperature_ladder(num_replicas: int, beta_min: float) -> torch.Tensor:
    """Geometric inverse-temperature ladder 1 = beta_0 > ... > beta_min,
    float32.  Geometric spacing equalizes the expected swap acceptance of
    adjacent pairs when the potential scales roughly linearly in beta."""
    if num_replicas < 2:
        raise ValueError("need at least 2 replicas")
    return torch.tensor(np.geomspace(1.0, beta_min, num_replicas),
                        dtype=torch.float32)


class PTState(NamedTuple):
    position: Any      # the cold replica's position (the target chain)
    inner: Any         # the inner batched kernel's state over K C rows
    step: int


def _check_betas(betas) -> np.ndarray:
    b = np.asarray(betas.cpu() if torch.is_tensor(betas) else betas,
                   np.float64)
    if b.ndim != 1 or b.size < 2:
        raise ValueError("betas must be a 1-D ladder with >= 2 entries")
    if abs(b[0] - 1.0) > 1e-6:
        raise ValueError("betas[0] must be 1.0 (the cold, target chain)")
    if np.any(b <= 0) or np.any(np.diff(b) >= 0):
        raise ValueError("betas must be positive and strictly decreasing")
    return b


def _make_pt(potential_rows: Callable, betas_np: np.ndarray,
             step_size: float, inner: str, swap_every: int,
             num_leapfrog: int, chain_axis: bool) -> TransitionKernel:
    """The PT kernel over row-major replicas.

    `potential_rows((K C, ...) leaves) -> (K C,)` unit-temperature
    potentials; `chain_axis` says whether the user's positions carry a
    leading C axis (the batch contract) or none (one chain, C = 1)."""
    if inner not in ("mala", "hmc"):
        raise ValueError(f"unknown inner move '{inner}'"
                         " (supported: 'mala', 'hmc')")
    K = int(betas_np.size)
    betas32 = torch.tensor(betas_np, dtype=torch.float32)

    def rows_of(position):
        """The user position stacked to K C replica rows (all replicas
        start at the same point; burn-in separates them)."""
        def one(leaf):
            lead = leaf.shape[0] if chain_axis else 1
            body = tuple(leaf.shape[1:] if chain_axis else leaf.shape)
            return leaf.reshape((1, lead) + body).expand(
                (K, lead) + body).reshape((K * lead,) + body)
        return tree_map(one, position)

    def pot_tempered(x_rows):
        u = potential_rows(x_rows)
        C = u.shape[0] // K
        return betas32.to(u.device).to(u.dtype).repeat_interleave(C) * u

    def build_inner(position_rows):
        leaf0 = tree_leaves(position_rows)[0]
        C = leaf0.shape[0] // K
        betas = betas32.to(leaf0.device)
        if inner == "mala":
            # per-replica step lr / beta_k through the diagonal metric
            # G_k = 1 / beta_k (G enters the MH ratio, so every replica
            # stays exact)
            inv = (1.0 / betas).repeat_interleave(C)
            precond = tree_map(
                lambda x: inv.to(x.dtype).reshape(
                    (K * C,) + (1,) * (x.dim() - 1)), position_rows)
            return mala_batched(pot_tempered, step_size, precond=precond)
        eps_rows = (step_size / torch.sqrt(betas)).repeat_interleave(C)
        return hmc_batched(pot_tempered, lambda step: eps_rows,
                           num_leapfrog=num_leapfrog, jitter=0.2)

    def split_kc(x):
        return x.reshape((K, x.shape[0] // K) + tuple(x.shape[1:]))

    def cold_of(inner_state):
        def one(leaf):
            cold = split_kc(leaf)[0]
            return cold if chain_axis else cold[0]
        return tree_map(one, inner_state.position)

    def init(position):
        rows = rows_of(position)
        s = build_inner(rows).init(rows)
        return PTState(cold_of(s), s, 0)

    def step(generator, state):
        s, info = build_inner(state.inner.position).step(generator,
                                                         state.inner)
        u_t = split_kc(s.potential)                   # (K, C) tempered
        C, dev = u_t.shape[1], u_t.device
        do_swap = (state.step + 1) % swap_every == 0
        if do_swap:
            # the deterministic even/odd exchange round
            parity = ((state.step + 1) // swap_every) % 2
            idx = np.arange(K)
            cand = np.where((idx - parity) % 2 == 0, idx + 1, idx - 1)
            partner_np = np.where((cand >= 0) & (cand < K) & (idx >= parity),
                                  cand, idx)
            paired = torch.as_tensor(partner_np != idx, device=dev)
            partner = torch.as_tensor(partner_np, device=dev)
            lo = torch.as_tensor(np.minimum(idx, partner_np), device=dev)
            bcol = betas32.to(dev)[:, None].to(u_t.dtype)
            u = u_t / bcol                            # unit temperature
            log_a = (bcol - bcol[partner]) * (u - u[partner])   # (K, C)
            usw = torch.rand((K, C), generator=generator, dtype=u.dtype,
                             device=dev)[lo]
            acc = (paired[:, None] & torch.isfinite(log_a)
                   & (torch.log(usw) < log_a))
            scale = bcol / bcol[partner]              # (K, 1)
            u_t = torch.where(acc, scale * u_t[partner], u_t)

            def swap_leaf(leaf, rescale):
                x = split_kc(leaf)
                a = acc.reshape(acc.shape + (1,) * (x.dim() - 2))
                src = x[partner]
                if rescale:
                    src = scale.reshape(scale.shape + (1,) * (x.dim() - 2)
                                        ).to(x.dtype) * src
                return torch.where(a, src, x).reshape(leaf.shape)

            s = s._replace(
                position=tree_map(lambda x: swap_leaf(x, False), s.position),
                potential=u_t.reshape(s.potential.shape),
                grad=tree_map(lambda x: swap_leaf(x, True), s.grad))
            swap_rate = acc.sum(dim=0).to(u_t.dtype) / max(
                int((partner_np != idx).sum()), 1)
        else:
            swap_rate = torch.zeros(C, dtype=u_t.dtype, device=dev)

        cold_u = u_t[0]
        cold_acc = split_kc(info["accepted"])[0]
        if not chain_axis:
            cold_u, cold_acc, swap_rate = cold_u[0], cold_acc[0], \
                swap_rate[0]
        new_info = {"potential": cold_u, "accepted": cold_acc,
                    "swap_accepted": swap_rate,
                    "step_size": info["step_size"]}
        return PTState(cold_of(s), s, state.step + 1), new_info

    return TransitionKernel(init, step)


def parallel_tempering_batched(potential_batch: Callable, betas,
                               step_size: float, inner: str = "mala",
                               swap_every: int = 1, num_leapfrog: int = 10
                               ) -> TransitionKernel:
    """Replica exchange over the batch-potential contract: the K-rung
    ladder multiplies the chain batch (K C rows), so one forward and
    backward pass a step covers every replica of every chain, and the
    exchange is elementwise between adjacent row blocks.  `betas`: the
    inverse-temperature ladder, betas[0] == 1 (`temperature_ladder`);
    `inner`: "mala" (step lr / beta_k) or "hmc" (eps / sqrt(beta_k),
    jittered leapfrogs); swaps every `swap_every` steps with alternating
    even/odd pairs.  The position and `info` are the cold (C, ...)
    batch's; `info["swap_accepted"]` is each chain's share of accepted
    swaps over the ladder's pairs."""
    return _make_pt(potential_batch, _check_betas(betas), step_size, inner,
                    swap_every, num_leapfrog, chain_axis=True)


def parallel_tempering(potential_fn: Callable, betas, step_size: float,
                       inner: str = "mala", swap_every: int = 1,
                       num_leapfrog: int = 10) -> TransitionKernel:
    """Replica exchange of one chain over a per-chain potential: the K
    replicas live inside the state, and the kernel's position is the cold
    chain."""
    def potential_rows(rows):
        R = tree_leaves(rows)[0].shape[0]
        return torch.stack([potential_fn(tree_map(lambda x: x[r], rows))
                            for r in range(R)])

    return _make_pt(potential_rows, _check_betas(betas), step_size, inner,
                    swap_every, num_leapfrog, chain_axis=False)
