"""Launch wrapper of the CUDA WKV6 kernels (`csrc/wkv6.cu`), the port of
`wkv6_pallas`.

Takes r, k, logw (B, S, H, D) and v (B, S, H, Dv) in the model layout,
one dtype (float32 or bfloat16), on one CUDA device, unit stride on the
last dim (the batch, time and head strides are passed to the kernel, so
no transpose runs); u broadcastable to (B, H, D); s0 (B, H, D, Dv) with
contiguous (D, Dv) blocks; D and Dv multiples of 16 up to 128.  u and s0
are taken in float32 (converted here if they are not).  Allocates o
(B, S, H, Dv) in the input dtype and the final state s (B, H, D, Dv) in
float32, both contiguous, and launches on PyTorch's current stream: the
step kernel for S = 1; for S > 1 the chunked closed form, whose three
kernels share a float32 workspace the wrapper allocates.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B

HEAD_DIMS = tuple(range(16, 129, 16))     # D and Dv each

WKV6 = B.Launcher("wkv6", "wkv6", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P,
    B.VOID_P, B.VOID_P, B.INT, B.INT, B.INT, B.INT, B.INT, *[B.INT64] * 16,
    B.INT, B.VOID_P])
CHUNK = 32                                # time steps a chunk (kC)


def workspace_floats(b: int, s: int, h: int, d: int, dv: int) -> int:
    """Float32 workspace of a call (`ChunkWs` a (batch, head, chunk): rq
    (C, D), U (D, Dv), the decay (D,), oi (C, Dv), the state at the
    chunk's start (D, Dv)); none for S = 1."""
    if s <= 1:
        return 0
    return b * h * -(-s // CHUNK) * (CHUNK * d + 2 * d * dv + d + CHUNK * dv)


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """(o (B, S, H, Dv), s_final (B, H, D, Dv))."""
    B.require_cuda("wkv6", r, k, v, logw, u, s0)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, logw)) or \
            v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError("wkv6: r, k and logw must share one (B, S, H, D) "
                         "shape and v be (B, S, H, Dv); got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    bsz, s, h, d = r.shape
    dv = v.shape[3]
    if d not in HEAD_DIMS or dv not in HEAD_DIMS:
        raise ValueError(f"wkv6: D {d} and Dv {dv} must be multiples of 16 "
                         f"up to 128")
    if s0.shape != (bsz, h, d, dv):
        raise ValueError(f"wkv6: s0 must be {(bsz, h, d, dv)}, got {tuple(s0.shape)}")
    code = B.dtype_code(r, "wkv6")
    if any(t.dtype != r.dtype for t in (k, v, logw)):
        raise TypeError("wkv6: r, k, v and logw must share one dtype")
    if any(t.stride(-1) != 1 for t in (r, k, v, logw)):
        raise ValueError("wkv6: the head dim must have stride 1")
    s0 = s0.float()
    if s0.stride(-1) != 1 or s0.stride(-2) != dv:
        raise ValueError("wkv6: s0's (D, Dv) blocks must be contiguous")
    ub = u.float().expand(bsz, h, d)      # (H, D) or (B, H, D); raises if neither
    if ub.stride(-1) != 1:
        raise ValueError("wkv6: u must have unit stride on D")
    o = torch.empty((bsz, s, h, dv), dtype=r.dtype, device=r.device)
    s_fin = torch.empty((bsz, h, d, dv), dtype=torch.float32, device=r.device)
    if o.numel() == 0:
        s_fin.copy_(s0)
        return o, s_fin
    n_ws = workspace_floats(bsz, s, h, d, dv)
    ws = torch.empty(n_ws, dtype=torch.float32, device=r.device) if n_ws else None
    WKV6(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
         ub.data_ptr(), s0.data_ptr(), o.data_ptr(), s_fin.data_ptr(),
         None if ws is None else ws.data_ptr(), bsz, s, h, d, dv,
         *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *logw.stride()[:3], ub.stride(0), ub.stride(1), s0.stride(0),
         s0.stride(1), code, B.stream(r))
    return o, s_fin
