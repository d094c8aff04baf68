"""Utilities of the PyTorch port: parameter-dict helpers, logging,
checkpoints."""
from .checkpoint import save_pytree  # noqa: F401
from .logging import RunLogger  # noqa: F401
from .pytree import tree_leaves, tree_map, tree_random_normal  # noqa: F401

__all__ = ["RunLogger", "save_pytree", "tree_leaves", "tree_map",
           "tree_random_normal"]
