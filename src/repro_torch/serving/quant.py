"""Int8 KV-cache quantization (from `repro.serving.quant`).

KV pages are stored as int8 with one float32 scale per (layer, page,
kv head): a page leaf `(L, P, ps, Hkv, hd)` carries scales
`(L, P, 1, Hkv, 1)`.  Symmetric absmax quantization:

    scale = max(max|x| / 127, 1e-8)   over the page's positions and hd
    q     = clip(round(x / scale), -127, 127)   (int8; round half to even)
    x'    = q * scale

The same helpers serve the pool layout `(L, P, ps, ...)`, the gathered
block layout `(L, n, npp, ps, ...)` and the dense rectangles
`(L, B, C, ...)`: `ps_axis` names the position axis.  Per-page scales
only work because the ragged prefill scatter zeroes pad positions and
every requantization zeroes positions past the slot's length: garbage in
a page's tail would inflate its absmax.

`kv_page_nbytes` and `pages_for_byte_budget` are computed from shapes
alone; nothing is allocated.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

INT8_MAX = 127.0
# floor for the absmax scale: an all-zero page quantizes to zeros instead
# of dividing by zero, and dequantizes back to exact zeros
SCALE_FLOOR = 1e-8


def _reduce_axes(ndim: int, ps_axis: int) -> tuple[int, int]:
    """Scales reduce over the page's position axis and the trailing
    feature axis (hd), keeping the kv-head axis: per-head scales."""
    return (ps_axis, ndim - 1)


def page_scales(x: torch.Tensor, ps_axis: int) -> torch.Tensor:
    """Per-(page, head) absmax / 127 scales of `x` (positions on
    `ps_axis`), float32 with the reduced axes kept as 1.  The division
    and the floor run in x's dtype and round there, as the JAX helper's
    weakly typed constants keep them, before the float32 cast."""
    amax = torch.amax(x.abs(), dim=_reduce_axes(x.dim(), ps_axis), keepdim=True)
    return torch.clamp(amax / INT8_MAX, min=SCALE_FLOOR).float()


def quantize_block(x: torch.Tensor, ps_axis: int):
    """(int8 codes, float32 scales) of a page block; symmetric absmax.
    The division and the rounding run in float32, as the JAX helper
    promotes `x / s` to its float32 scale."""
    s = page_scales(x, ps_axis)
    q = torch.clamp(torch.round(x.float() / s), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, s


def dequantize_block(q: torch.Tensor, s: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * s.to(dtype)


def requantize(x: torch.Tensor, lengths: torch.Tensor, pos_axis: int,
               page_size: int | None = None):
    """(int8 codes, float32 scales) of float values `x` after a step: the
    positions on `pos_axis` at or past each lane's length (`lengths`, one
    a lane on axis pos_axis - 1) are zeroed first, so stale values (a
    reused page's, the never-read null page's, a rectangle's tail) cannot
    inflate a scale.  One scale block spans the whole position axis, or
    with `page_size` each page of it: the axis is cut into (pages,
    page_size) and the codes and scales come back in that layout."""
    shape = [1] * x.dim()
    shape[pos_axis - 1], shape[pos_axis] = -1, x.shape[pos_axis]
    pos = torch.arange(x.shape[pos_axis], device=x.device)
    live = (pos[None, :] < lengths.to(x.device)[:, None]).reshape(shape)
    x = torch.where(live, x, torch.zeros((), dtype=x.dtype, device=x.device))
    if page_size is None:
        return quantize_block(x, pos_axis)
    x = x.reshape(*x.shape[:pos_axis], -1, page_size, *x.shape[pos_axis + 1:])
    return quantize_block(x, pos_axis + 1)


def scale_struct(segments: list, device=None) -> list:
    """Zero scales matching a pool's or a rectangle's segments: {"k", "v"}
    leaves (L, P, ps, Hkv, hd) take (L, P, 1, Hkv, 1), MLA's {"latent"}
    leaves (L, P, ps, D) take (L, P, 1, 1) (page or slot axis 1, positions
    axis 2)."""
    out = []
    for seg in segments:
        leaves = {}
        for key, a in seg.items():
            shape = list(a.shape)
            for ax in _reduce_axes(a.dim(), 2):
                shape[ax] = 1
            leaves[key] = torch.zeros(shape, dtype=torch.float32,
                                      device=device or a.device)
        out.append(leaves)
    return out


def _page_shapes(mcfg: ModelConfig, page_size: int) -> list[tuple[int, ...]]:
    """The shapes of one page's leaves ({"k", "v"} or MLA's {"latent"})
    over every layer, as `transformer.init_paged_cache` lays them out
    with one page."""
    return [shape for _, count in transformer.layer_segments(mcfg)
            for shape in transformer.entry_shapes(mcfg, count, 1, page_size).values()]


def kv_page_nbytes(mcfg: ModelConfig, page_size: int, quant: bool) -> int:
    """Device bytes one KV page costs (its scales included when `quant`),
    from shapes alone.  int8 pages cost about a quarter of float32 pages
    and half of bfloat16 ones, so a fixed byte budget holds that many
    more slots."""
    elem = 1 if quant else torch.empty((), dtype=mcfg.tdtype).element_size()
    total = 0
    for shape in _page_shapes(mcfg, page_size):
        n = 1
        for x in shape:
            n *= x
        total += n * elem
        if quant:          # (L, 1, 1, Hkv, 1) or (L, 1, 1, 1) float32
            total += n // (shape[2] * shape[-1]) * 4
    return total


def pages_for_byte_budget(mcfg: ModelConfig, budget_bytes: int,
                          page_size: int, quant: bool) -> int:
    """Allocatable pages (beyond the null page) that fit in
    `budget_bytes` of KV memory."""
    per = kv_page_nbytes(mcfg, page_size, quant)
    return max(int(budget_bytes) // per - 1, 1)
