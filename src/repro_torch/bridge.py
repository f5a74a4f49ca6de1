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

The tree helpers walk nested dicts, lists and tuples as JAX's pytrees
do (`tree_paths` in `tree_flatten_with_path` order), so the optimizer
state and checkpoint leaves line up with the JAX package's.
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


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """`fn` applied to every leaf of nested dicts/lists/tuples, in the
    same structure; with `rest`, fn(leaf, *the same position of each
    other tree), the structure followed being the first tree's (so a
    leaf of it may meet a whole subtree of another)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unzip(structure: Any, tree: Any, n: int) -> list:
    """n trees of `structure`'s shape out of `tree`, which holds an
    n-tuple at each of structure's leaves."""
    return [tree_map(lambda _, t, i=i: t[i], structure, tree) for i in range(n)]


def tree_paths(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) of every leaf in JAX's `tree_flatten_with_path` order:
    dict keys sorted, list and tuple indices in order, None leaves left
    out (an empty subtree to JAX)."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [e for i, v in enumerate(tree) for e in tree_paths(v, prefix + (i,))]
    return [] if tree is None else [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    """The leaves in `tree_paths` order (`jax.tree_util.tree_leaves`')."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(template: Any, leaves: list) -> Any:
    """`template`'s structure (dict key order kept) holding `leaves`, given
    in `tree_paths` order; None leaves stay None."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    return build(template)


def tree_to_torch(tree: Any, device: str | torch.device = "cpu") -> Any:
    """Nested dicts/lists/tuples of arrays to the same structure of
    tensors on `device`."""
    return tree_map(lambda a: None if a is None else array_to_tensor(a, device),
                    tree)


def tree_to(tree: Any, device: str | torch.device) -> Any:
    """Move every tensor of a nested structure to `device`."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t,
                    tree)
