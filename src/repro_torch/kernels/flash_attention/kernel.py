"""Launch wrapper of the CUDA flash attention kernel
(`csrc/flash_attention.cu`), the port of `flash_attention_bhsd`.

Takes q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd) in the model layout on one
CUDA device, one dtype (float32 or bfloat16), unit stride on hd (other
strides are passed to the kernel, so no transpose runs), hd in
{32, 64, 128}.  Allocates the (B, Sq, H, hd) output and launches on
PyTorch's current stream.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build as B

HEAD_DIMS = (32, 64, 128)

FLASH = B.Launcher("flash_attention", "flash_attention", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.INT, B.INT, B.INT, B.INT,
    B.INT, B.INT, B.INT64, B.INT64, B.INT64, B.INT64, B.INT64, B.INT64,
    B.INT64, B.INT64, B.INT64, B.INT, B.INT, B.FLOAT, B.INT, B.VOID_P])


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    B.require_cuda("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q (B, Sq, H, hd), k/v (B, Sk, Hkv,"
                         f" hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != hd or hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: incompatible q {tuple(q.shape)} "
                         f"and k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must share one dtype")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must have stride 1")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if b * h > 65535:
        raise ValueError("flash_attention: B * H exceeds the grid's y limit")
    code = B.dtype_code(q, "flash_attention")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    FLASH(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv,
          sq, sk, hd, q.stride(0), q.stride(1), q.stride(2), k.stride(0),
          k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
          int(causal), 0 if window is None else int(window),
          1.0 / math.sqrt(hd), code, B.stream(q))
    return out
