"""Saving parameter trees to .npz (counterpart of
`bayesian_ode_tpu/utils/checkpoint.py::save_pytree`; loading is ROADMAP
queue 1 item 6)."""
from __future__ import annotations

import os
from typing import Any

import numpy as np

from .pytree import tree_leaves, treedef_str


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of tensors as an .npz, atomically (tmp file +
    os.replace), in the layout of the JAX package's save_pytree: the
    leaves as leaf_0.. in `tree_leaves` order and the structure under
    __treedef__ as JAX prints it.  A dict's sorted keys are also stored
    under __keys__."""
    apath = os.path.abspath(path)
    os.makedirs(os.path.dirname(apath), exist_ok=True)
    if not apath.endswith(".npz"):
        apath += ".npz"
    keys = sorted(tree) if isinstance(tree, dict) else []
    leaves = [x.detach().cpu().numpy() if hasattr(x, "detach")
              else np.asarray(x) for x in tree_leaves(tree)]
    tmp = apath + ".tmp.npz"
    np.savez(tmp, __treedef__=np.asarray(treedef_str(tree)),
             __keys__=np.asarray(keys, dtype=str),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    os.replace(tmp, apath)
