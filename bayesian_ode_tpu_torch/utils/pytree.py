"""Helpers over parameter dicts of tensors.

Counterpart of the part of `bayesian_ode_tpu/utils/pytree.py` the
samplers need.  A "tree" here is a dict of tensors (the port's parameter
containers) or a single tensor; dict leaves are visited in sorted key
order, as `jax.tree` orders dict keys.
"""
from __future__ import annotations

from typing import Callable, Dict, Union

import torch

Tree = Union[torch.Tensor, Dict[str, torch.Tensor]]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: fn(tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return [tree]


def tree_random_normal(generator: torch.Generator, tree: Tree) -> Tree:
    """A tree of iid standard normals shaped like `tree`, drawn from
    `generator` leaf by leaf in sorted key order."""
    return tree_map(
        lambda x: torch.randn(x.shape, generator=generator, dtype=x.dtype,
                              device=x.device), tree)
