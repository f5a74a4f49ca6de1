"""Launch wrappers of the CUDA attention kernels, on one CUDA device,
one dtype (float32, bfloat16 or float16), unit stride on hd (other
strides are passed to the kernels, so no transpose runs); each allocates
its output and launches on PyTorch's current stream.

* `flash_attention_cuda` (`csrc/flash_attention.cu`), the port of
  `flash_attention_bhsd`: q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd) in the
  model layout -> (B, Sq, H, hd), any hd (up to 256 zero-padded to a
  kernel's width; past 256 the column-split kernel).  bfloat16 and
  float16 take the tensor-core tile with the warps a block that
  `kernels/_attn_plan.py` picks (its inputs on 16-byte boundaries,
  strides in multiples of 8 elements); float32 the FMA kernel.
* `paged_decode_attention_cuda` (`csrc/paged_decode.cu`), the port of
  `paged_decode_attention_hp`: one query token a slot, q (B, 1, H, hd),
  against one layer's page pools (P, ps, Hkv, hd) through int32 page
  tables (B, npp) and lengths (B,) that count the current token ->
  (B, 1, H, hd), any hd up to 4096 (past 1024 in blocks of output
  columns).  The positions are split across blocks by
  `kernels/_attn_plan.py:paged_plan` (from the shapes, never the
  lengths); with more than one split the wrapper allocates a float32
  workspace of the splits' partials, which a second kernel of the same C
  call merges in split order.
* `paged_decode_attention_int8_cuda`, the same op over an int8 pool with
  one float32 scale a (page, kv head) (`serving/quant.py`): the current
  token's k and v come unquantized beside the pool, as the JAX engine
  attends before it quantizes; the FMA route of the same kernel
  dequantizes the pages into its float32 ring as it loads them, and reads
  q and the current k/v and writes out in q's dtype.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _attn_plan
from repro_torch.kernels import _build as B

HEAD_DIMS = _attn_plan.HEAD_DIMS          # flash_attention's kernels

LOG2E = 1.4426950408889634

FLASH = B.Launcher("flash_attention", "flash_attention", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.INT, B.INT, B.INT, B.INT,
    B.INT, B.INT, B.INT64, B.INT64, B.INT64, B.INT64, B.INT64, B.INT64,
    B.INT64, B.INT64, B.INT64, B.INT, B.INT, B.FLOAT, B.INT, B.INT, B.INT,
    B.INT, B.VOID_P])


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
    if k.shape[0] != b or k.shape[3] != hd or hkv < 1 or h % hkv or hd < 1:
        raise ValueError(f"flash_attention: incompatible q {tuple(q.shape)} "
                         f"and k/v {tuple(k.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must share one dtype")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    B.dtype_code(q, "flash_attention")
    return padded_flash(q, k, v, causal=causal, window=window,
                        hd_to=_attn_plan.padded_head_dim(hd))


def padded_flash(q, k, v, *, causal: bool, window: int | None, hd_to: int,
                 run=None):
    """`run(q, k, v, causal, window, scale)` at head dim `hd_to` >= hd:
    q, k and v zero-padded on hd (the padded columns add zero terms to
    every score, and the padded output columns are dropped), the scale
    kept at 1 / sqrt(hd).  Without `run`, one launch of the kernel."""
    hd = q.shape[-1]
    run = run or launch
    scale = 1.0 / math.sqrt(hd)
    if hd_to == hd:
        return run(q, k, v, causal, window, scale)
    q, k, v = (F.pad(t, (0, hd_to - hd)) for t in (q, k, v))
    return run(q, k, v, causal, window, scale)[..., :hd].contiguous()


def launch(q, k, v, causal: bool, window: int | None, scale: float,
           warps: int | None = None) -> torch.Tensor:
    """One launch at a head dim of `HEAD_DIMS`, or past the last on the
    column split; a view without unit hd stride (16-bit types on the
    tensor-core tile: off 16-byte boundaries, or with strides not in
    multiples of 8 elements) is copied.  `warps` overrides the plan's
    block size (tensor-core tile)."""
    b, sq, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    code = B.DTYPE_CODES[q.dtype]
    wide = hd > HEAD_DIMS[-1]
    q, k, v = (t if _readable(t, wide) else t.contiguous() for t in (q, k, v))
    stages, cblocks = 0, _attn_plan.flash_column_blocks(hd)
    if wide:
        warps = 0
        if -(-sq // _attn_plan.WIDE_ROWS) > 65535:
            raise ValueError("flash_attention: Sq exceeds the grid's y limit")
    elif q.dtype in B.HALF_TYPES:
        plan = _attn_plan.flash_plan(b, h, hkv, sq, hd, sms=_sm_count(q.device.index or 0))
        warps, stages = warps or plan.warps, plan.stages
        if plan.grid[1] > 65535:
            raise ValueError("flash_attention: Sq exceeds the grid's y limit")
    else:
        warps = 0
        if b * h > 65535:
            raise ValueError("flash_attention: B * H exceeds the grid's y limit")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    FLASH(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv,
          sq, sk, hd, *_strides(q), *_strides(k), *_strides(v),
          int(causal), 0 if window is None else int(window), scale, warps,
          stages, cblocks, code, B.stream(q))
    return out


def _readable(t: torch.Tensor, wide: bool = False) -> bool:
    """Unit hd stride; on the tensor-core tile (16-bit types, hd <= 256)
    also a 16-byte aligned base and strides in multiples of 8 elements
    (16-byte cp.async rows; a size-1 dim's stride is never used)."""
    if t.stride(-1) != 1:
        return False
    return wide or t.dtype not in B.HALF_TYPES or (t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1))


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Batch, sequence and head strides, those of size-1 dims as 0 (they
    are never stepped, and PyTorch may give them any value)."""
    return tuple(st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride()[:3]))


PAGED = B.Launcher("paged_decode", "paged_decode", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P,
    *[B.INT] * 11, *[B.INT64] * 8, B.FLOAT, B.INT, B.VOID_P])
PAGED_INT8 = B.Launcher("paged_decode", "paged_decode_int8", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P,
    *[B.INT] * 11, *[B.INT64] * 8, B.VOID_P, B.VOID_P, B.INT64, B.INT64,
    B.VOID_P, B.VOID_P, B.INT64, B.INT64, B.FLOAT, B.INT, B.VOID_P])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_paged(what: str, q, k_pages, v_pages, tables, lengths) -> None:
    """Raise on shapes the paged kernels do not take."""
    if q.dim() != 4 or q.shape[1] != 1 or k_pages.dim() != 4 or \
            k_pages.shape != v_pages.shape:
        raise ValueError(f"{what}: q (B, 1, H, hd), pools (P, ps, Hkv, hd); got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    b, _, h, hd = q.shape
    hkv = k_pages.shape[2]
    if k_pages.shape[3] != hd or hkv < 1 or h % hkv:
        raise ValueError(f"{what}: incompatible q {tuple(q.shape)} and pools "
                         f"{tuple(k_pages.shape)} (H % Hkv == 0)")
    if tables.dim() != 2 or tables.shape[0] != b or \
            tables.dtype != torch.int32 or not tables.is_contiguous() or \
            lengths.shape != (b,) or lengths.dtype != torch.int32 or \
            not lengths.is_contiguous():
        raise ValueError(f"{what}: tables must be a contiguous int32 (B, npp), "
                         f"lengths a contiguous int32 (B,)")


def paged_decode_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, tables: torch.Tensor,
                                lengths: torch.Tensor) -> torch.Tensor:
    B.require_cuda("paged_decode_attention", q, k_pages, v_pages, tables,
                   lengths)
    _check_paged("paged_decode_attention", q, k_pages, v_pages, tables, lengths)
    b, _, h, hd = q.shape
    _, ps, hkv, _ = k_pages.shape
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_decode_attention: q and the pools must share "
                         "one dtype")
    # a head dim without unit stride is copied to one (for the pools, a
    # copy of all of them: no served path passes such a view)
    q, k_pages, v_pages = (t if t.stride(-1) == 1 else t.contiguous()
                           for t in (q, k_pages, v_pages))
    code = B.dtype_code(q, "paged_decode_attention")
    es = q.element_size()
    # rows on 16-byte steps (aligned pool bases, strides and rows) take
    # 16-byte cp.async copies and may take the tensor-core route; other
    # pools are read value by value (never copied: the pool is large)
    aligned = hd * es % 16 == 0 and not any(
        t.data_ptr() % 16 or any(st * es % 16 for st in t.stride()[:3])
        for t in (k_pages, v_pages))
    out = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    npp = tables.shape[1]
    plan = _attn_plan.paged_plan(b, h, hkv, npp, ps, hd, es,
                                 sms=_sm_count(q.device.index or 0),
                                 aligned=aligned)
    n_ws = plan.workspace_floats(b, h, hd)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device) if n_ws else None
    PAGED(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
          tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
          None if ws is None else ws.data_ptr(), b, h, hkv, hd, ps, npp,
          plan.pages, plan.splits, plan.heads, plan.head_chunks,
          plan.col_blocks, q.stride(0), q.stride(2), *k_pages.stride()[:3],
          *v_pages.stride()[:3], LOG2E / math.sqrt(hd), code, B.stream(q))
    return out


def paged_decode_attention_int8_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor, k_scales: torch.Tensor,
                                     v_scales: torch.Tensor, tables: torch.Tensor,
                                     lengths: torch.Tensor, k_new: torch.Tensor,
                                     v_new: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, hd); int8 pools (P, ps, Hkv, hd); float32 scales (P, 1,
    Hkv, 1); k_new / v_new (B, Hkv, hd), the current token's, which the
    pool does not hold yet, in q's dtype.  The kernel reads q and the
    current k/v in their dtype, attends in float32 and rounds the output
    to q's dtype once."""
    what = "paged_decode_attention_int8"
    B.require_cuda(what, q, k_pages, v_pages, k_scales, v_scales, tables,
                   lengths, k_new, v_new)
    _check_paged(what, q, k_pages, v_pages, tables, lengths)
    b, _, h, hd = q.shape
    n_pages, ps, hkv, _ = k_pages.shape
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise TypeError(f"{what}: the pools must be int8")
    for t in (k_scales, v_scales):
        if t.shape != (n_pages, 1, hkv, 1) or t.dtype != torch.float32:
            raise ValueError(f"{what}: scales must be float32 {(n_pages, 1, hkv, 1)}")
    for t in (k_new, v_new):
        if t.shape != (b, hkv, hd):
            raise ValueError(f"{what}: the current k/v must be {(b, hkv, hd)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: the current k/v must be in q's dtype {q.dtype}")
    code = B.dtype_code(q, what)
    k_pages, v_pages = (t if t.stride(-1) == 1 else t.contiguous()
                        for t in (k_pages, v_pages))
    # unit hd strides; the current k/v contiguous (the two share their
    # strides), as the scales share theirs (a layer's slice)
    if q.stride(-1) != 1:
        q = q.contiguous()
    kn, vn = k_new.contiguous(), v_new.contiguous()
    if k_scales.stride() != v_scales.stride():
        k_scales, v_scales = k_scales.contiguous(), v_scales.contiguous()
    out = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    npp = tables.shape[1]
    plan = _attn_plan.paged_plan(b, h, hkv, npp, ps, hd, 4, aligned=False,
                                 sms=_sm_count(q.device.index or 0))
    n_ws = plan.workspace_floats(b, h, hd)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device) if n_ws else None
    PAGED_INT8(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
               tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
               None if ws is None else ws.data_ptr(), b, h, hkv, hd, ps, npp,
               plan.pages, plan.splits, plan.heads, plan.head_chunks,
               plan.col_blocks, q.stride(0), q.stride(2), *k_pages.stride()[:3],
               *v_pages.stride()[:3], k_scales.data_ptr(), v_scales.data_ptr(),
               k_scales.stride(0), k_scales.stride(2), kn.data_ptr(), vn.data_ptr(),
               kn.stride(0), kn.stride(1), LOG2E / math.sqrt(hd), code, B.stream(q))
    return out
