"""Launch wrapper of the CUDA RG-LRU scan kernel (`csrc/rglru_scan.cu`),
the port of `rglru_scan_pallas`.

Takes a, b (B, S, W) and h0 (B, W), float32, on one CUDA device, unit
stride on W (the batch and time strides are passed to the kernel, so a
slice such as the last step of an earlier scan needs no copy).
Allocates the contiguous (B, S, W) float32 output and launches on
PyTorch's current stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B

SCAN = B.Launcher("rglru_scan", "rglru_scan", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.INT, B.INT, B.INT,
    B.INT64, B.INT64, B.INT64, B.INT64, B.INT64, B.VOID_P])


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor) -> torch.Tensor:
    B.require_cuda("rglru_scan", a, b, h0)
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan: a, b (B, S, W) and h0 (B, W); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(h0.shape)}")
    if any(t.dtype != torch.float32 for t in (a, b, h0)):
        raise TypeError("rglru_scan: a, b and h0 must be float32")
    if any(t.stride(-1) != 1 for t in (a, b, h0)):
        raise ValueError("rglru_scan: the channel axis must have stride 1")
    bsz, s, w = a.shape
    out = torch.empty((bsz, s, w), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if bsz > 65535:
        raise ValueError("rglru_scan: B exceeds the grid's y limit")
    SCAN(a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), bsz, s, w,
         a.stride(0), a.stride(1), b.stride(0), b.stride(1), h0.stride(0),
         B.stream(a))
    return out
