"""Forward sensitivities of ODE solutions.

Counterpart of `bayesian_ode_tpu/ode/sensitivity.py`, which takes
`jax.jacfwd` through the solver.  Here forward-mode AD
(`torch.autograd.forward_ad`) runs through the solver's step loop once
per parameter element: the right tool when the parameter count is small
(the Van der Pol models have 2-74 parameters).  The step sizes follow the
primal solve, as they do under jacfwd.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.autograd.forward_ad as fwAD

from ..utils.pytree import tree_leaves, tree_map, tree_unflatten
from .odeint import odeint


def odeint_forward_sensitivity(func: Callable, y0, t, params,
                               rtol: float = 1e-7, atol: float = 1e-9,
                               method: Optional[str] = None,
                               options: Optional[Dict[str, Any]] = None):
    """Returns (ys, dys/dparams) for `func(t, y, params)`.

    dys/dparams has the structure jax.jacfwd gives: for a tensor solution,
    a tree shaped like params whose leaves are (*ys.shape, *leaf.shape);
    for a tree solution, that tree of params-shaped trees.
    """
    def solve(p):
        return odeint(lambda t_, y_: func(t_, y_, p), y0, t, rtol, atol,
                      method, options)

    leaves = tree_leaves(params)
    with torch.no_grad():
        ys = solve(params)
    ys_leaves = tree_leaves(ys)
    # jac[j][k]: d ys_leaves[j] / d leaves[k], (*ys.shape, *leaf.shape)
    jac = [[None] * len(leaves) for _ in ys_leaves]
    for k, leaf in enumerate(leaves):
        cols = [[] for _ in ys_leaves]
        for e in range(leaf.numel()):
            tangent = torch.zeros_like(leaf).reshape(-1)
            tangent[e] = 1.0
            with fwAD.dual_level():
                duals = list(leaves)
                duals[k] = fwAD.make_dual(leaf, tangent.reshape(leaf.shape))
                out = solve(tree_unflatten(params, duals))
                for j, o in enumerate(tree_leaves(out)):
                    tan = fwAD.unpack_dual(o).tangent
                    cols[j].append(torch.zeros_like(o) if tan is None
                                   else tan.detach())
        for j, y in enumerate(ys_leaves):
            jac[j][k] = torch.stack(cols[j], dim=-1).reshape(
                tuple(y.shape) + tuple(leaf.shape))
    sens = [tree_unflatten(params, row) for row in jac]
    if torch.is_tensor(ys):
        return ys, sens[0]
    it = iter(sens)
    return ys, tree_map(lambda _: next(it), ys)
