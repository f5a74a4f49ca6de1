"""Plain PyTorch version of the RG-LRU scan kernel: the CPU path of `ops`
and the oracle the CUDA kernel is held against."""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t, a sequential loop over axis 1 in
    float32 from h0.  a, b: (B, S, W); h0: (B, W) -> h (B, S, W) in a's
    dtype."""
    af, bf = a.float(), b.float()
    h = h0.float()
    out = torch.empty(af.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)
