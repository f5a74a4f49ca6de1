"""Gradient compression of the port (from `repro.parallel.compression`):
per-tensor int8 quantization with error feedback, what an int8
data-parallel all-reduce would carry.  On one device the training loop
applies it as quantize-dequantize (`compressed_gradients`), the error
feedback riding in the optimizer state."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.bridge import tree_map, tree_unzip

Params = Any


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, float32 scale) with x ~ q * scale, scale = max|x| / 127;
    `torch.round` rounds half to even, as `jnp.round` does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_tree(grads: Params, err: Params) -> tuple[Params, Params, Params]:
    """(quantized ints, scales, new error feedback)."""
    def one(g, e):
        ge = g.float() + e
        q, s = quantize_int8(ge)
        return q, s, ge - dequantize_int8(q, s)
    return tuple(tree_unzip(grads, tree_map(one, grads, err), 3))


def decompress_tree(q: Params, scales: Params) -> Params:
    return tree_map(dequantize_int8, q, scales)


def compressed_gradients(grads: Params, err: Params) -> tuple[Params, Params]:
    """Quantize-dequantize the gradient tree with error feedback: (g_hat,
    err_new)."""
    q, s, err_new = compress_tree(grads, err)
    return decompress_tree(q, s), err_new
