"""Carry state across from the JAX package.

`from_numpy_tree(tree, device)` turns a tree of arrays — dicts, lists and
tuples whose leaves are numpy arrays or anything with `__array__` (such as
the JAX package's arrays) — into the same tree of torch tensors with the
same keys, shapes and dtypes, on `device`. Leaves without `__array__`
(Python numbers, strings, dtype objects) pass through unchanged. Tests use
it to feed both packages identical utility objects, ctx, populations,
deltas, tabu rings and island states.
"""

from __future__ import annotations

import numpy as np
import torch


def from_numpy_tree(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if hasattr(tree, "__array__") and not isinstance(tree, type):
        arr = np.array(tree, copy=True)
        return torch.from_numpy(arr).to(device)
    return tree
