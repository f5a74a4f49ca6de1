"""Launch wrapper of the CUDA WKV6 kernel (`csrc/wkv6.cu`), the port of
`wkv6_pallas`.

Takes r, k, v, logw (B, S, H, D) in the model layout, float32, on one
CUDA device, unit stride on D (the batch, time and head strides are
passed to the kernel, so no transpose runs); u broadcastable to
(B, H, D); s0 (B, H, D, D) with contiguous (D, D) blocks; D in
{16, 32, 64}.  Allocates o (B, S, H, D) and the final state s
(B, H, D, D), both contiguous float32, and launches on PyTorch's
current stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B

HEAD_DIMS = (16, 32, 64)

WKV6 = B.Launcher("wkv6", "wkv6", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P,
    B.VOID_P, B.INT, B.INT, B.INT, B.INT, *[B.INT64] * 16, B.VOID_P])


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """(o (B, S, H, D), s_final (B, H, D, D))."""
    B.require_cuda("wkv6", r, k, v, logw, u, s0)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError("wkv6: r, k, v and logw must share one (B, S, H, D) "
                         f"shape; got {[tuple(t.shape) for t in (r, k, v, logw)]}")
    bsz, s, h, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {d} not in {HEAD_DIMS}")
    if s0.shape != (bsz, h, d, d):
        raise ValueError(f"wkv6: s0 must be {(bsz, h, d, d)}, got {tuple(s0.shape)}")
    if any(t.dtype != torch.float32 for t in (r, k, v, logw, u, s0)):
        raise TypeError("wkv6: every input must be float32")
    if any(t.stride(-1) != 1 for t in (r, k, v, logw)):
        raise ValueError("wkv6: the head dim must have stride 1")
    if s0.stride(-1) != 1 or s0.stride(-2) != d:
        raise ValueError("wkv6: s0's (D, D) blocks must be contiguous")
    ub = u.expand(bsz, h, d)          # (H, D) or (B, H, D); raises if neither
    if ub.stride(-1) != 1:
        raise ValueError("wkv6: u must have unit stride on D")
    o = torch.empty((bsz, s, h, d), dtype=torch.float32, device=r.device)
    s_fin = torch.empty((bsz, h, d, d), dtype=torch.float32, device=r.device)
    if o.numel() == 0:
        s_fin.copy_(s0)
        return o, s_fin
    WKV6(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
         ub.data_ptr(), s0.data_ptr(), o.data_ptr(), s_fin.data_ptr(),
         bsz, s, h, d, *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
         *logw.stride()[:3], ub.stride(0), ub.stride(1), s0.stride(0),
         s0.stride(1), B.stream(r))
    return o, s_fin
