"""Weight bridge: the JAX package's parameter (or cache) tree, given as
nested dicts and lists of numpy arrays, to the port's tensors.

The JAX transformer stacks each segment's layer weights on a leading
axis (`segments[i]["kind_dense"]`, shapes `(L, ...)`); the port keeps the
same tree and layout, so a path such as
`segments/0/kind_dense/attn/wq` names the same array on both sides.

JAX bf16 arrays arrive as numpy arrays of the `ml_dtypes` bfloat16
dtype, which `torch.from_numpy` refuses; they cross as their raw 16-bit
patterns (`uint16` -> `int16` -> a `torch.bfloat16` view), so no value
is rounded and `ml_dtypes` is never imported.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def array_to_tensor(a: Any, device: str | torch.device = "cpu") -> torch.Tensor:
    """One numpy array (or numpy scalar) to a tensor on `device`.  The
    values are copied: arrays that JAX hands out are read-only, and the
    port updates caches in place."""
    arr = np.array(a, order="C", copy=True)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.uint16).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def tree_map(fn, tree: Any) -> Any:
    """`fn` applied to every leaf of nested dicts/lists/tuples, in the
    same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_to_torch(tree: Any, device: str | torch.device = "cpu") -> Any:
    """Nested dicts/lists/tuples of arrays to the same structure of
    tensors on `device`."""
    return tree_map(lambda a: None if a is None else array_to_tensor(a, device),
                    tree)


def tree_to(tree: Any, device: str | torch.device) -> Any:
    """Move every tensor of a nested structure to `device`."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t,
                    tree)
