"""Gradient compression of the port (from `repro.parallel.compression`):
per-tensor int8 quantization with error feedback, what an int8
data-parallel all-reduce would carry.  On one device the training loop
applies it as quantize-dequantize (`compressed_gradients`), the error
feedback riding in the optimizer state.  On a mesh a leaf's scale is the
whole leaf's (its max |x| over the ranks its spec shards it across, one
all_reduce MAX), as JAX's global array gives."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.bridge import tree_leaves, tree_map, tree_unflatten, tree_unzip
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding

Params = Any


def quantize_int8(x: torch.Tensor, mesh=None, axes=()) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, float32 scale) with x ~ q * scale, scale = max|x| / 127
    (on a mesh the max over the ranks of `axes` too); `torch.round`
    rounds half to even, as `jnp.round` does."""
    xf = x.float()
    amax = xf.abs().max()
    if mesh is not None and axes:
        amax = coll.all_max(amax, mesh, axes)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_tree(grads: Params, err: Params, mesh=None,
                  specs=None) -> tuple[Params, Params, Params]:
    """(quantized ints, scales, new error feedback); on a mesh `specs`
    holds the gradients' specs by '/'-joined path."""
    axes = [()] * len(tree_leaves(grads)) if mesh is None else \
        [sharding.spec_axes(s) for s in sharding.leaf_specs(grads, specs)]

    def one(g, e, ax):
        ge = g.float() + e
        q, s = quantize_int8(ge, mesh, ax)
        return q, s, ge - dequantize_int8(q, s)
    return tuple(tree_unzip(grads, tree_map(one, grads, err,
                                            tree_unflatten(grads, axes)), 3))


def decompress_tree(q: Params, scales: Params) -> Params:
    return tree_map(dequantize_int8, q, scales)


def compressed_gradients(grads: Params, err: Params, mesh=None,
                         specs=None) -> tuple[Params, Params]:
    """Quantize-dequantize the gradient tree with error feedback: (g_hat,
    err_new); on a mesh each leaf scaled by its whole max."""
    q, s, err_new = compress_tree(grads, err, mesh, specs)
    return decompress_tree(q, s), err_new
