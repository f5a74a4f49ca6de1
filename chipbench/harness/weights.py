"""Seeded weights, drawn on the device in the type they are served in.

A family's layout (`chipbench/layouts/<family>.py`: `leaves(cfg)`, each
leaf's path, shape and standard deviation) is laid out in one flat
buffer, filled by one `torch.randn` from a generator seeded on the
device, and each leaf, a view of it, is scaled in place.  The same seed
gives the same weights on the same device, so the reference can draw
them again once the program is freed.
"""
from __future__ import annotations

import math

import torch

ALIGN = 64          # elements: every leaf starts on a 128-byte boundary in 16-bit types


def _insert(tree: dict, path: tuple, leaf) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if key not in node:
            node[key] = {}
        node = node[key]
    node[path[-1]] = leaf


def _lists(node):
    """Dicts keyed 0..n-1 become lists (the engine's `segments`)."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def draw(leaves, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weight tree of `leaves` ([(path, shape, std)]) from `seed`."""
    offsets, total = [], 0
    for _, shape, _ in leaves:
        offsets.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    tree: dict = {}
    for (path, shape, std), off in zip(leaves, offsets):
        view = flat[off:off + math.prod(shape)].view(shape)
        view.mul_(std)
        _insert(tree, path, view)
    return _lists(tree)

