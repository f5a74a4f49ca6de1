"""Decode state behind the serving engine (from `repro.serving.state`).

The engine's scheduling (admission, EDF shedding, slot rotation,
preemption) never touches cache layout; it talks to a decode state that
owns the per-slot model state and knows how to (a) prefill a request
into slot b and (b) advance the active slots one decode step at a fixed
lane width.  This slice ports `PagedKVState`, compact and full width.
The dense rectangles (`DenseKVState`), int8 KV and the recurrent and
cross-attention states are not ported yet.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

from . import paged as paged_kv

Params = Any


def _lane_map(sel: list[int]) -> dict[int, int]:
    """slot id -> first lane carrying it (padding lanes repeat slots)."""
    lane: dict[int, int] = {}
    for j, b in enumerate(sel):
        lane.setdefault(b, j)
    return lane


class PagedKVState:
    """Block-paged KV: PagePool + bucketed prefill + gathered decode."""

    kind = "paged"
    paged = True
    cache = None

    def __init__(self, mcfg: ModelConfig, max_batch: int, max_len: int, *,
                 decode_batch: int, compact: bool, page_size: int,
                 num_pages: int | None, bucket_min: int,
                 device: torch.device):
        self.mcfg = mcfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.decode_batch = decode_batch
        self.compact = compact
        self.device = device
        self.pool = paged_kv.PagePool(mcfg, max_batch, max_len,
                                      page_size=page_size,
                                      num_pages=num_pages, device=device)
        self.buckets = paged_kv.prefill_buckets(max_len, bucket_min)
        self.capacity = paged_kv.pool_token_capacity(self.pool, max_len)

    def prefill(self, params: Params, b: int, seq: np.ndarray) -> torch.Tensor:
        """Bucket-padded prefill of `seq` into slot b's pages; returns
        the (1, 1, V) last-real-token logits."""
        plen = len(seq)
        bucket = paged_kv.bucket_for(plen, self.buckets)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = seq
        trow = self.pool.table_row(b, bucket // self.pool.page_size)
        last = paged_kv.paged_prefill(
            self.mcfg, params, torch.as_tensor(toks, device=self.device),
            plen, self.pool.segments, trow, self.pool.page_size)
        self.pool.index[b] = plen
        return last

    def decode(self, params: Params, next_token: np.ndarray,
               active: list[int]):
        """One gathered decode over the page pool at a fixed lane width
        (decode_batch when compacting, max_batch for the full-width
        emulation)."""
        width = self.decode_batch if self.compact else self.max_batch
        sel = active + [active[0]] * (width - len(active))
        sel_arr = np.asarray(sel)
        logits = paged_kv.paged_decode(
            self.mcfg, params,
            torch.as_tensor(next_token[sel_arr], dtype=torch.long,
                            device=self.device),
            self.pool.segments, self.pool.tables[sel_arr],
            self.pool.index[sel_arr])
        # lengths are host-side numpy: advance them here
        self.pool.index[np.asarray(active)] += 1
        return logits, _lane_map(sel)

    def release(self, b: int) -> None:
        self.pool.release(b)
