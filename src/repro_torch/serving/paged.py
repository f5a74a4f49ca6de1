"""Block-paged KV cache + bucketed prefill (from `repro.serving.paged`).

* **Pages** — KV lives in per-layer pools of fixed-size pages
  (`transformer.init_paged_cache`); each slot owns a list of physical
  pages recorded in its page-table row.  Page 0 is the null page: every
  unused table entry points at it and its contents are never read
  (attention masks by per-slot length).  Tables and lengths are host
  numpy arrays; allocation and freeing are exact free-list accounting.
* **Bucketed prefill** — prompts are right-padded to the next
  power-of-two bucket; causal attention makes the padding exact.  The
  prefill scatter is ragged: pad positions are zeroed and table entries
  whose page starts at or past the prompt length go to the null page, so
  a slot's pages hold real KV and zeros, nothing else.
* **Decode** with `attn_impl == "flash"` runs straight from the pools:
  each layer writes the token's k/v into its page and the
  `paged_decode_attention` op attends through the page table.  Any other
  `attn_impl` gathers the selected slots' pages into the dense (n, C, ...)
  layout `transformer.decode_step` reads, runs it and scatters the pages
  back, as the JAX package does; that route is the pool route's oracle.
* **int8 KV** (`PagePool(quant=True)`, `serving/quant.py`): int8 pages
  with one float32 scale per (layer, page, kv head).  Prefill attends
  over unquantized KV and quantizes each bucket page.  The gather route
  dequantizes the gathered pages to float32, decodes, zeroes positions
  at or past each lane's new length and requantizes every gathered page
  with fresh scales (`_gather_pages_dequant`, `_scatter_pages_quant`).
  The pool route attends from the int8 pool with the token's k/v given
  beside it (`paged_decode_attention_int8`), then requantizes only the
  page the token went to: an unchanged page requantizes to the same
  codes and scales.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import api, transformer
from repro_torch.models.config import ModelConfig

from . import quant as kvq


def prefill_buckets(max_len: int, min_bucket: int = 16) -> tuple[int, ...]:
    """Power-of-two prompt-length buckets: `min_bucket, 2*min_bucket, ...`
    up to the first bucket that covers `max_len - 1`."""
    b = max(1, 1 << max(0, int(min_bucket) - 1).bit_length())
    out = [b]
    while out[-1] < max_len - 1:
        out.append(out[-1] * 2)
    return tuple(out)


def bucket_for(plen: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket that holds a `plen`-token prompt."""
    for b in buckets:
        if plen <= b:
            return b
    raise ValueError(f"prompt of {plen} tokens exceeds the largest bucket {buckets[-1]}")


class PagePool:
    """Fixed-size KV pages with per-slot page tables and host-side
    free-list accounting.  Not thread-safe: the serving engine is the
    single writer."""

    def __init__(self, mcfg: ModelConfig, max_batch: int, max_len: int, *,
                 page_size: int = 16, num_pages: int | None = None,
                 quant: bool = False, device: torch.device | str = "cpu"):
        if page_size < 1 or page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got {page_size}")
        self.page_size = page_size
        self.max_batch = max_batch
        self.pages_per_slot = -(-max_len // page_size)
        # default: capacity parity with a dense cache (+1 null page)
        self.num_pages = num_pages or 1 + max_batch * self.pages_per_slot
        if self.num_pages < 2:
            raise ValueError("need at least one allocatable page beyond the null page")
        # quant: int8 pages + per-(layer, page, kv head) float32 scales
        self.quant = quant
        self.segments = api.init_paged_cache(
            mcfg, self.num_pages, page_size, device=device,
            dtype=torch.int8 if quant else None)
        self.scales = kvq.scale_struct(self.segments) if quant else None
        # device bytes one page costs (scales included), from shapes alone
        self.page_nbytes = kvq.kv_page_nbytes(mcfg, page_size, quant)
        self.tables = np.zeros((max_batch, self.pages_per_slot), np.int32)
        self.index = np.zeros((max_batch,), np.int32)
        self._free = list(range(self.num_pages - 1, 0, -1))  # pop() allocates ascending
        self._owned: list[list[int]] = [[] for _ in range(max_batch)]
        self.stats = {"page_allocs": 0, "page_frees": 0, "peak_pages_in_use": 0}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def owned(self, b: int) -> tuple[int, ...]:
        return tuple(self._owned[b])

    def ensure(self, b: int, n_tokens: int) -> bool:
        """Grow slot `b` to hold `n_tokens`; False if the free list is
        short (caller preempts or waits).  Never partially allocates."""
        need = self.pages_for(n_tokens)
        have = len(self._owned[b])
        if need <= have:
            return True
        if need - have > len(self._free) or need > self.pages_per_slot:
            return False
        fresh = [self._free.pop() for _ in range(need - have)]
        self._owned[b].extend(fresh)
        self.tables[b, have:need] = fresh
        self.stats["page_allocs"] += len(fresh)
        self.stats["peak_pages_in_use"] = max(self.stats["peak_pages_in_use"],
                                              self.pages_in_use)
        return True

    def release(self, b: int) -> None:
        """Return slot `b`'s pages to the free list and null its table."""
        pages = self._owned[b]
        if pages:
            self.stats["page_frees"] += len(pages)
            self._free.extend(reversed(pages))
            self._owned[b] = []
            self.tables[b] = 0
        self.index[b] = 0

    def table_row(self, b: int, n_entries: int) -> np.ndarray:
        """The first `n_entries` table entries of slot `b` (null-padded)."""
        row = (self._owned[b] + [0] * n_entries)[:n_entries]
        return np.asarray(row, np.int32)


def _gather_pages(segments: list, tables_sel: torch.Tensor) -> list:
    """Pool pages -> the dense (L, n, C, ...) cache layout, via per-slot
    tables (n, pages_per_slot)."""
    n, npp = tables_sel.shape

    def leaf(a):  # (L, P, ps, ...)
        g = a[:, tables_sel]  # (L, n, npp, ps, ...)
        return g.reshape(a.shape[0], n, npp * a.shape[2], *a.shape[3:])

    return [{k: leaf(a) for k, a in seg.items()} for seg in segments]


def _scatter_pages(segments: list, dense: list, tables_sel: torch.Tensor) -> None:
    """Write an advanced dense sub-cache back through the page tables, in
    place.  Duplicate physical ids only occur for padding lanes (identical
    content) and the never-read null page, so write order is irrelevant."""
    n, npp = tables_sel.shape
    for seg, dseg in zip(segments, dense):
        for key, a in seg.items():
            d = dseg[key]
            a[:, tables_sel] = d.reshape(a.shape[0], n, npp, a.shape[2],
                                         *a.shape[3:]).to(a.dtype)


def _gather_pages_dequant(segments: list, scales: list,
                          tables_sel: torch.Tensor) -> list:
    """int8 pool pages -> the dequantized float32 dense (L, n, C, ...)
    layout; each page's scale broadcasts over its positions and hd."""
    n, npp = tables_sel.shape

    def leaf(a, sc):  # a: (L, P, ps, ...) int8; sc: (L, P, 1, ...) float32
        d = kvq.dequantize_block(a[:, tables_sel], sc[:, tables_sel])
        return d.reshape(a.shape[0], n, npp * a.shape[2], *a.shape[3:])

    return [{k: leaf(a, ssc[k]) for k, a in seg.items()}
            for seg, ssc in zip(segments, scales)]


def _scatter_pages_quant(segments: list, scales: list, dense: list,
                         tables_sel: torch.Tensor, new_len: torch.Tensor) -> None:
    """Requantize an advanced dense sub-cache into the int8 pages with
    fresh per-page scales, in place.  Positions at or past each lane's new
    length (`new_len`, (n,)) are zeroed first, so a reused page's stale
    values (or the never-read null page's) cannot inflate a scale."""
    for seg, ssc, dseg in zip(segments, scales, dense):
        for key, a in seg.items():
            # (L, n, C, ...) -> (L, n, npp, ps, ...)
            q, sc = kvq.requantize(dseg[key], new_len, 2, page_size=a.shape[2])
            a[:, tables_sel] = q
            ssc[key][:, tables_sel] = sc


def _requantize_page(codes: torch.Tensor, scales: torch.Tensor,
                     pages: torch.Tensor, offs: torch.Tensor,
                     new: torch.Tensor) -> None:
    """Write the token's k or v into its int8 page, in place: the page
    dequantized to float32, `new` (n, Hkv, hd) written at `offs`,
    positions past it zeroed (they are not live yet) and the page
    requantized with fresh scales.  codes (P, ps, Hkv, hd) int8, scales
    (P, 1, Hkv, 1); pages, offs (n,).  Padding lanes repeat a real slot,
    so their writes are identical."""
    page = kvq.dequantize_block(codes[pages], scales[pages])   # (n, ps, Hkv, hd)
    page[torch.arange(page.shape[0], device=page.device), offs] = new.float()
    q, sc = kvq.requantize(page, offs + 1, 1)
    codes[pages] = q
    scales[pages] = sc


def paged_decode_step_int8(cfg: ModelConfig, params, tokens: torch.Tensor,
                           segments: list, scales: list, tables: torch.Tensor,
                           index: torch.Tensor) -> torch.Tensor:
    """`transformer.paged_decode_step` over an int8 pool, in place.  In
    each layer `paged_decode_attention_int8` attends over the dequantized
    live positions and the token's own k/v, unquantized (the JAX engine
    attends before it quantizes); then the page the token went to is
    requantized with the token in it (`_requantize_page`).  Every other
    page is left as it is: requantizing an unchanged page gives its codes
    and scales back.  segments: per segment {"k", "v"} int8 pools;
    scales: per segment {"k", "v"} (L, P, 1, Hkv, 1) float32."""
    transformer.check_supported(cfg)
    n = tokens.shape[0]
    index = index.long()
    ps = segments[0]["k"].shape[2]
    rows = torch.arange(n, device=tokens.device)
    pages = tables.long()[rows, index // ps]
    offs = index % ps
    lengths = (index + 1).to(torch.int32)
    caches = [{"k": seg["k"], "v": seg["v"], "ks": sc["k"], "vs": sc["v"]}
              for seg, sc in zip(segments, scales)]

    def attn(p, h, lc, rope):
        q, k, v = transformer._roped_qkv(cfg, p, h, rope)
        o = fops.paged_decode_attention_int8(q, lc["k"], lc["v"], lc["ks"],
                                             lc["vs"], tables, lengths,
                                             k[:, 0], v[:, 0])
        _requantize_page(lc["k"], lc["ks"], pages, offs, k[:, 0])
        _requantize_page(lc["v"], lc["vs"], pages, offs, v[:, 0])
        return o.reshape(n, 1, -1) @ p["wo"].to(cfg.tdtype)

    return transformer._decode_layers(cfg, params, tokens, index, caches, attn)


def paged_decode(mcfg: ModelConfig, params, tokens: torch.Tensor,
                 segments: list, tables_sel: np.ndarray,
                 index_sel: np.ndarray, scales: list | None = None) -> torch.Tensor:
    """One decode step over the page pool (pools updated in place):
    attention from the pool itself when mcfg.attn_impl == "flash", else
    gather -> decode_step -> scatter.  `scales`: the int8 pool's (the
    pages are int8).  Returns the (n, 1, V) logits."""
    dev = tokens.device
    if mcfg.attn_impl == "flash":
        tables = torch.as_tensor(tables_sel, dtype=torch.int32, device=dev)
        index = torch.as_tensor(index_sel, dtype=torch.long, device=dev)
        if scales is not None:
            return paged_decode_step_int8(
                mcfg, params, tokens, segments, scales, tables, index)
        return transformer.paged_decode_step(mcfg, params, tokens, segments,
                                             tables, index)
    tsel = torch.as_tensor(tables_sel, dtype=torch.long, device=dev)
    idx = torch.as_tensor(index_sel, dtype=torch.int32, device=dev)
    dense = _gather_pages(segments, tsel) if scales is None \
        else _gather_pages_dequant(segments, scales, tsel)
    logits, new = api.decode_step(
        mcfg, params, tokens, {"segments": dense, "index": idx})
    if scales is None:
        _scatter_pages(segments, new["segments"], tsel)
    else:
        _scatter_pages_quant(segments, scales, new["segments"], tsel,
                             new["index"].long())
    return logits


def paged_prefill(mcfg: ModelConfig, params, toks: torch.Tensor, plen: int,
                  segments: list, table_row: np.ndarray,
                  page_size: int, scales: list | None = None) -> torch.Tensor:
    """Padded prefill of one bucket-length prompt + ragged per-page
    scatter into the pools (in place).  `toks` is (1, bucket),
    right-padded past `plen`; returns the (1, 1, V) logits of the last
    real token.  With `scales` (an int8 pool) each bucket page is
    quantized with its own fresh scales."""
    bucket = toks.shape[1]
    if bucket % page_size:
        raise ValueError(f"bucket {bucket} is not a multiple of page_size {page_size}")
    npp_b = bucket // page_size
    dev = toks.device
    x, kvs = transformer.hidden(mcfg, params, toks, collect_kv=True)
    last = transformer.unembed(mcfg, params, x[:, plen - 1:plen])
    page_live = np.arange(npp_b) * page_size < plen
    row = torch.as_tensor(np.where(page_live, table_row, 0), dtype=torch.long,
                          device=dev)
    pad = torch.arange(bucket, device=dev) >= plen
    for i, (seg_pool, seg_kv) in enumerate(zip(segments, kvs)):
        for key, kv in seg_kv.items():  # (L, 1, bucket, ...)
            a = seg_pool[key]
            kv = kv[:, 0].masked_fill(pad.view(1, -1, *([1] * (kv.dim() - 3))), 0)
            pages = kv.reshape(a.shape[0], npp_b, page_size, *a.shape[3:])
            if scales is None:
                a[:, row] = pages.to(a.dtype)
            else:
                q, sc = kvq.quantize_block(pages, ps_axis=2)
                a[:, row] = q
                scales[i][key][:, row] = sc
    return last


def paged_supported(mcfg: ModelConfig) -> bool:
    """Paged + bucketed serving is exact for the plain transformer cache
    (no sliding-window ring, no MoE)."""
    return mcfg.family == "transformer" and not mcfg.window and not mcfg.use_moe


def pool_token_capacity(pool: PagePool, max_len: int) -> int:
    """Hard per-slot token ceiling: the engine finishes a request at this
    boundary instead of overrunning its pages."""
    return min(max_len, pool.pages_per_slot * pool.page_size)
