"""Saving and restoring trees of tensors (sampler states, collected chains)
as .npz: counterpart of `bayesian_ode_tpu/utils/checkpoint.py`."""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from .pytree import tree_leaves, tree_map, treedef_str


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


def load_pytree(path: str, like: Any) -> Any:
    """Restore a tree saved by `save_pytree`, with `like` for its
    structure.  The stored structure is checked against `like`'s, with a
    clear error on a mismatch.  A leaf comes back as a tensor on the
    device and in the dtype of `like`'s leaf, or as a Python scalar where
    `like` holds one (a sampler's host step counter)."""
    with np.load(path, allow_pickle=False) as data:
        stored, expected = str(data["__treedef__"]), treedef_str(like)
        if stored != expected:
            raise ValueError(
                f"checkpoint structure mismatch:\n saved: {stored}\n "
                f"expected: {expected}")
        saved = iter([data[f"leaf_{i}"]
                      for i in range(len(tree_leaves(like)))])

    def restore(ref):
        x = next(saved)
        if torch.is_tensor(ref):
            return torch.from_numpy(np.array(x)).to(device=ref.device,
                                                     dtype=ref.dtype)
        return type(ref)(x.item())

    return tree_map(restore, like)
