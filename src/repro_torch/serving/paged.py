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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import api, transformer
from repro_torch.models.config import ModelConfig


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
                 device: torch.device | str = "cpu"):
        if page_size < 1 or page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got {page_size}")
        self.page_size = page_size
        self.max_batch = max_batch
        self.pages_per_slot = -(-max_len // page_size)
        # default: capacity parity with a dense cache (+1 null page)
        self.num_pages = num_pages or 1 + max_batch * self.pages_per_slot
        if self.num_pages < 2:
            raise ValueError("need at least one allocatable page beyond the null page")
        self.segments = api.init_paged_cache(mcfg, self.num_pages, page_size,
                                             device=device)
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


def paged_decode(mcfg: ModelConfig, params, tokens: torch.Tensor,
                 segments: list, tables_sel: np.ndarray,
                 index_sel: np.ndarray) -> torch.Tensor:
    """One decode step over the page pool (pools updated in place):
    attention from the pool itself when mcfg.attn_impl == "flash", else
    gather -> decode_step -> scatter.  Returns the (n, 1, V) logits."""
    dev = tokens.device
    if mcfg.attn_impl == "flash":
        return transformer.paged_decode_step(
            mcfg, params, tokens, segments,
            torch.as_tensor(tables_sel, dtype=torch.int32, device=dev),
            torch.as_tensor(index_sel, dtype=torch.long, device=dev))
    tsel = torch.as_tensor(tables_sel, dtype=torch.long, device=dev)
    dense = _gather_pages(segments, tsel)
    idx = torch.as_tensor(index_sel, dtype=torch.int32, device=dev)
    logits, new = api.decode_step(
        mcfg, params, tokens, {"segments": dense, "index": idx})
    _scatter_pages(segments, new["segments"], tsel)
    return logits


def paged_prefill(mcfg: ModelConfig, params, toks: torch.Tensor, plen: int,
                  segments: list, table_row: np.ndarray,
                  page_size: int) -> torch.Tensor:
    """Padded prefill of one bucket-length prompt + ragged per-page
    scatter into the pools (in place).  `toks` is (1, bucket),
    right-padded past `plen`; returns the (1, 1, V) logits of the last
    real token."""
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
    for seg_pool, (k, v) in zip(segments, kvs):
        for key, kv in (("k", k), ("v", v)):  # kv: (L, 1, bucket, Hkv, hd)
            a = seg_pool[key]
            kv = kv[:, 0].masked_fill(pad[None, :, None, None], 0)
            a[:, row] = kv.reshape(a.shape[0], npp_b, page_size,
                                   *a.shape[3:]).to(a.dtype)
    return last


def paged_supported(mcfg: ModelConfig) -> bool:
    """Paged + bucketed serving is exact for the plain transformer cache
    (no sliding-window ring, no MoE)."""
    return mcfg.family == "transformer" and not mcfg.window and not mcfg.use_moe


def pool_token_capacity(pool: PagePool, max_len: int) -> int:
    """Hard per-slot token ceiling: the engine finishes a request at this
    boundary instead of overrunning its pages."""
    return min(max_len, pool.pages_per_slot * pool.page_size)
