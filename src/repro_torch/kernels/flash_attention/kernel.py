"""Launch wrappers of the CUDA attention kernels, on one CUDA device,
one dtype (float32 or bfloat16), unit stride on hd (other strides are
passed to the kernels, so no transpose runs), hd in {32, 64, 128}; each
allocates its output and launches on PyTorch's current stream.

* `flash_attention_cuda` (`csrc/flash_attention.cu`), the port of
  `flash_attention_bhsd`: q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd) in the
  model layout -> (B, Sq, H, hd).
* `paged_decode_attention_cuda` (`csrc/paged_decode.cu`), the port of
  `paged_decode_attention_hp`: one query token a slot, q (B, 1, H, hd),
  against one layer's page pools (P, ps, Hkv, hd) through int32 page
  tables (B, npp) and lengths (B,) that count the current token ->
  (B, 1, H, hd).
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


PAGED = B.Launcher("paged_decode", "paged_decode", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.INT, B.INT,
    B.INT, B.INT, B.INT, B.INT, B.INT64, B.INT64, B.INT64, B.INT64, B.INT64,
    B.INT64, B.INT64, B.INT64, B.FLOAT, B.INT, B.VOID_P])
MAX_GROUP = 16       # query heads a kv head serves (csrc/paged_decode.cu)


def paged_decode_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, tables: torch.Tensor,
                                lengths: torch.Tensor) -> torch.Tensor:
    B.require_cuda("paged_decode_attention", q, k_pages, v_pages, tables,
                   lengths)
    if q.dim() != 4 or q.shape[1] != 1 or k_pages.dim() != 4 or \
            k_pages.shape != v_pages.shape:
        raise ValueError("paged_decode_attention: q (B, 1, H, hd), pools "
                         f"(P, ps, Hkv, hd); got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    b, _, h, hd = q.shape
    _, ps, hkv, _ = k_pages.shape
    if k_pages.shape[3] != hd or hkv < 1 or h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"paged_decode_attention: incompatible q "
                         f"{tuple(q.shape)} and pools {tuple(k_pages.shape)} "
                         f"(H % Hkv == 0, H / Hkv <= {MAX_GROUP})")
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_decode_attention: q and the pools must share "
                         "one dtype")
    if any(t.stride(-1) != 1 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_decode_attention: the head dim must have "
                         "stride 1")
    if tables.dim() != 2 or tables.shape[0] != b or \
            tables.dtype != torch.int32 or not tables.is_contiguous() or \
            lengths.shape != (b,) or lengths.dtype != torch.int32 or \
            not lengths.is_contiguous():
        raise ValueError("paged_decode_attention: tables must be a contiguous"
                         " int32 (B, npp), lengths a contiguous int32 (B,)")
    if hkv > 65535:
        raise ValueError("paged_decode_attention: grid limits exceeded")
    code = B.dtype_code(q, "paged_decode_attention")
    out = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    PAGED(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
          tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h, hkv,
          hd, ps, tables.shape[1], q.stride(0), q.stride(2),
          k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
          v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
          1.0 / math.sqrt(hd), code, B.stream(q))
    return out
