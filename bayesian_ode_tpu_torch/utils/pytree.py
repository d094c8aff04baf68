"""Helpers over parameter trees of tensors.

Counterpart of the part of `bayesian_ode_tpu/utils/pytree.py` the
samplers and the ODE solvers need, with `ravel_pytree` (jax.flatten_util's,
which that module re-exports) for the particle ensembles of SVGD.  A
"tree" here is a tensor, or a dict, list or tuple of trees: the GP
model's {"U", "logsn"} dict, the MLP's layer list [{"w", "b"}, ...], the
adjoint's augmented state (y, a_y, a_t, a_params), a sampler's state (a
NamedTuple, whose Python counters are leaves too).  Leaves are visited as
`jax.tree` visits them: lists, tuples and NamedTuples in order, dict keys
sorted; None is an empty subtree.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

Tree = Any


def _children(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        kids = (tree_map(fn, x, *(r[i] for r in rest))
                for i, x in enumerate(tree))
        return type(tree)(*kids) if hasattr(tree, "_fields") \
            else type(tree)(kids)
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_unflatten(like: Tree, leaves) -> Tree:
    """A tree shaped like `like` holding `leaves` in `tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_dot(a: Tree, b: Tree):
    """Full inner product across all leaves (sum of elementwise
    products)."""
    return sum((x * y).sum() for x, y in zip(tree_leaves(a), tree_leaves(b)))


def ravel_pytree(tree: Tree):
    """(flat, unravel): the leaves of `tree` flattened row-major and
    concatenated in `tree_leaves` order (dict keys sorted), as
    `jax.flatten_util.ravel_pytree` flattens them, and the inverse.

    `unravel(v)` takes a vector (P,) or a batch (..., P) and returns a tree
    of leaves shaped (..., *leaf.shape), where the JAX package vmaps its
    unravel over the batch."""
    leaves = tree_leaves(tree)
    shapes = [tuple(x.shape) for x in leaves]
    sizes = [x.numel() for x in leaves]
    flat = torch.cat([x.reshape(-1) for x in leaves])

    def unravel(v):
        parts = torch.split(v, sizes, dim=-1)
        return tree_unflatten(tree, [p.reshape(v.shape[:-1] + s)
                                     for p, s in zip(parts, shapes)])

    return flat, unravel


def ravel_batch(tree: Tree):
    """(flat (B, P), unravel) of a tree whose leaves carry a leading batch
    axis B: each system's leaves raveled as `ravel_pytree` ravels one, and
    the inverse (a (B, P) batch back to the tree)."""
    leaves = tree_leaves(tree)
    B = leaves[0].shape[0]
    shapes = [tuple(x.shape[1:]) for x in leaves]
    sizes = [x[0].numel() for x in leaves]

    def unravel(v):
        parts = torch.split(v, sizes, dim=1)
        return tree_unflatten(tree, [p.reshape((v.shape[0],) + s)
                                     for p, s in zip(parts, shapes)])

    return torch.cat([x.reshape(B, -1) for x in leaves], dim=1), unravel


def treedef_str(tree: Tree) -> str:
    """The structure of `tree` as `str(jax.tree.structure(tree))` prints it,
    e.g. "PyTreeDef([{'b': *, 'w': *}])"."""
    def rec(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {rec(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(rec(x) for x in t) + "]"
        if hasattr(t, "_fields"):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(rec(x) for x in t) + "])")
        if isinstance(t, tuple):
            inner = ", ".join(rec(x) for x in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({rec(tree)})"


def tree_random_normal(generator: torch.Generator, tree: Tree) -> Tree:
    """A tree of iid standard normals shaped like `tree`, drawn from
    `generator` leaf by leaf in `tree_leaves` order."""
    return tree_map(
        lambda x: torch.randn(x.shape, generator=generator, dtype=x.dtype,
                              device=x.device), tree)


def tree_sum_squares_per_chain(tree: Tree) -> torch.Tensor:
    """Per-chain sum of squares: each leaf reduced over all axes but the
    leading chain axis, then summed across leaves.  Returns (C,)."""
    return sum(x.reshape(x.shape[0], -1).pow(2).sum(dim=1)
               for x in tree_leaves(tree))


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(lambda x, y: x + y, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(lambda x, y: x - y, a, b)


def tree_scale(c, a: Tree) -> Tree:
    return tree_map(lambda x: c * x, a)


def tree_axpy(c, x: Tree, y: Tree) -> Tree:
    """y + c * x, leafwise."""
    return tree_map(lambda x_, y_: y_ + c * x_, x, y)


def tree_where(pred, a: Tree, b: Tree) -> Tree:
    """Leafwise `where` with a scalar (or broadcastable) predicate."""
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def tree_sum_squares(a: Tree):
    return sum((x * x).sum() for x in tree_leaves(a))


def tree_size(a: Tree) -> int:
    """Total element count of a tree."""
    return sum(x.numel() for x in tree_leaves(a))


def safe_sqrt(x):
    """sqrt with zero (not infinite) slope at x == 0, so norms of
    exactly-zero residuals don't poison derivatives (double-where trick)."""
    nonzero = x > 0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, x, 1.0)),
                       0.0)


def tree_rms_norm(a: Tree):
    """RMS norm over all leaves: ||x||_2 / sqrt(numel)."""
    return safe_sqrt(tree_sum_squares(a) / tree_size(a))


def tree_stack_scalar_weighted(weights, trees):
    """sum_i weights[i] * trees[i] for a list of same-structure trees."""
    out = tree_scale(weights[0], trees[0])
    for w, t in zip(weights[1:], trees[1:]):
        out = tree_axpy(w, t, out)
    return out
