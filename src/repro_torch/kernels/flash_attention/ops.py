"""Public flash attention op in the model layout: q (B, Sq, H, hd), k/v
(B, Sk, Hkv, hd) -> (B, Sq, H, hd).

A CPU tensor takes the plain PyTorch version (`ref`); a CUDA tensor
launches the CUDA kernel, which raises on anything it does not take.
The paged decode kernel (`paged_decode_attention_hp`) is not ported yet.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window)
