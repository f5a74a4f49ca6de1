"""Launch wrapper of the CUDA WKV6 kernels (`csrc/wkv6.cu`), the port of
`wkv6_pallas`.

Takes r, k, logw (B, S, H, D) and v (B, S, H, Dv) in the model layout,
one dtype (float32 or bfloat16), on one CUDA device (the batch, time and
head strides are passed to the kernels, so no transpose runs); u
broadcastable to (B, H, D); s0 (B, H, D, Dv).  u and s0 are taken in
float32 (converted here if they are not).  Returns o (B, S, H, Dv) in the
input dtype and the final state s (B, H, D, Dv) in float32, both
contiguous; launches on PyTorch's current stream: the step kernel for
S = 1; for S > 1 the chunked closed form, whose three kernels share a
float32 workspace the wrapper allocates.

The kernels take D and Dv multiples of 16 up to 128 (`HEAD_DIMS`).
`widened` runs any D and Dv on them, as the JAX kernel takes any:
* Dv > 128: independent column blocks of at most 128 (value columns
  never mix: exact);
* D > 128: row blocks of at most 128, run in float32 and their outputs
  summed in block order (state rows of different d never mix: only the
  final sum's order changes), o rounded once to the input dtype;
* other widths: zero-padded to the next multiple of 16, with r, k, u and
  s0 set to 0 and logw to 0 (w = 1) in the padding, so padded state rows
  stay exactly 0; the outputs are sliced.
A last dim without unit stride, and an s0 whose (D, Dv) blocks are not
contiguous, are copied.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build as B

HEAD_DIMS = tuple(range(16, 129, 16))     # D and Dv each, as the kernels take them
MAX_WIDTH = HEAD_DIMS[-1]

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


def _blocks(n: int) -> list[tuple[int, int]]:
    """[start, end) blocks of at most 128 covering n."""
    return [(i, min(n, i + MAX_WIDTH)) for i in range(0, n, MAX_WIDTH)]


def widened(run, r, k, v, logw, u, s0):
    """`run(r, k, v, logw, u, s0) -> (o, s_final)`, a call that takes D
    and Dv in `HEAD_DIMS`, on any D and Dv (module docstring).  u is
    (H, D) or (B, H, D)."""
    d, dv = r.shape[-1], v.shape[-1]
    if d > MAX_WIDTH:
        parts = [widened(run, r[..., a:e].float(), k[..., a:e].float(), v.float(),
                         logw[..., a:e].float(), u[..., a:e], s0[..., a:e, :])
                 for a, e in _blocks(d)]
        o = parts[0][0]
        for po, _ in parts[1:]:
            o = o + po
        return o.to(r.dtype), torch.cat([ps for _, ps in parts], dim=-2)
    if dv > MAX_WIDTH:
        parts = [widened(run, r, k, v[..., a:e], logw, u, s0[..., a:e])
                 for a, e in _blocks(dv)]
        return (torch.cat([po for po, _ in parts], dim=-1),
                torch.cat([ps for _, ps in parts], dim=-1))
    pd, pv = -d % 16, -dv % 16
    if pd or pv:
        pad = lambda t, n: F.pad(t, (0, n))
        o, st = run(pad(r, pd), pad(k, pd), pad(v, pv), pad(logw, pd), pad(u, pd),
                    F.pad(s0, (0, pv, 0, pd)))
        return o[..., :dv].contiguous(), st[..., :d, :dv].contiguous()
    return run(r, k, v, logw, u, s0)


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
    if min(d, dv) < 1:
        raise ValueError(f"wkv6: D {d} and Dv {dv} must be >= 1")
    if s0.shape != (bsz, h, d, dv):
        raise ValueError(f"wkv6: s0 must be {(bsz, h, d, dv)}, got {tuple(s0.shape)}")
    B.dtype_code(r, "wkv6")
    if any(t.dtype != r.dtype for t in (k, v, logw)):
        raise TypeError("wkv6: r, k, v and logw must share one dtype")
    ub = u.float().expand(bsz, h, d)      # (H, D) or (B, H, D); raises if neither
    return widened(_native, r, k, v, logw, ub, s0.float())


def _native(r, k, v, logw, ub, s0):
    """One launch at D and Dv in `HEAD_DIMS`."""
    bsz, s, h, d = r.shape
    dv = v.shape[3]
    assert d in HEAD_DIMS and dv in HEAD_DIMS, (d, dv)
    r, k, v, logw, ub = (t if t.stride(-1) == 1 else t.contiguous()
                         for t in (r, k, v, logw, ub))
    if s0.stride(-1) != 1 or s0.stride(-2) != dv:
        s0 = s0.contiguous()
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
         *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *logw.stride()[:3],
         ub.stride(0), ub.stride(1), s0.stride(0), s0.stride(1),
         B.DTYPE_CODES[r.dtype], B.stream(r))
    return o, s_fin
