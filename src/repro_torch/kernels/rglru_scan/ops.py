"""Public RG-LRU scan op, the signature of the JAX op: a, b (B, S, W),
h0 (B, W) -> h (B, S, W) with h_t = a_t * h_{t-1} + b_t.

A CPU tensor takes the plain PyTorch version (`ref`); a CUDA tensor
launches the CUDA kernel, which raises on anything it does not take.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    return kernel.rglru_scan_cuda(a, b, h0)
