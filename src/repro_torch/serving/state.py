"""Decode state behind the serving engine (from `repro.serving.state`).

The engine's scheduling (admission, EDF shedding, slot rotation,
preemption) never touches cache layout; it talks to a decode state that
owns the per-slot model state and knows how to (a) prefill a request
into slot b and (b) advance the active slots one decode step at a fixed
lane width.  Ported: `PagedKVState` (compact and full width) for the
plain transformer, `DenseKVState` for every other transformer (sliding
window, MoE, MLA latents, or `paged=False`), `RecurrentState` for the
rglru and rwkv6 families and `CrossAttnState` for whisper.  Both KV
states take int8 storage (`quantized`, `serving/quant.py`).  Every
state's `prefill` takes the request's `frames`; only the cross-attention
state reads them.

`place(mesh)` readies a state for a mesh before any prefill (the JAX
states' `place`).  The dense bf16 / f32 rectangles take
`sharding.cache_specs` (the JAX `cache_shardings`): KV heads over
"model" when the attention shards on whole heads, MLA latents' cache
length over "model", and over "data" the slots when they divide, or,
with one slot, its cache length (SP).  With the config's
`cache_seq_shard` (which JAX reads in its dry run alone) a cache whose
KV heads do not split has its length over "model" too.  Every rank
still runs the engine's one scheduler over every slot: prefill runs
replicated over "data" and only the owning data row (SP: every row, its
block of the length) keeps the splice, each rank its block of a length
split over "model"; decode runs each row's own slots
(`use_mesh(data_split=True)`, MoE routed over the batch gathered in the
step's lane order) and gathers the rows' logits over "data", so every
rank samples from the same logits in JAX's lane order; under a split
length each rank attends over its block and the softmax is combined
over the split's ranks.  The page pools and the int8 dense rectangles
take `kv_head_specs` (KV heads over "model"; every data rank holds every
slot, as JAX leaves them).  The recurrent and cross-attention states
reallocate their per-layer leaves at this rank's channels and heads
(`sharding.layer_state_specs`: rglru's `h` and conv window, rwkv6's
`wkv`, the KV of rglru's ring and of whisper's self and cross
attention; token shifts whole; every slot on every data rank), so the
batch-1 caches a prefill makes under the mesh splice in as they are.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.bridge import tree_map
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding

from . import paged as paged_kv
from . import quant as kvq

Params = Any


def _lane_map(sel: list[int]) -> dict[int, int]:
    """slot id -> first lane carrying it (padding lanes repeat slots)."""
    lane: dict[int, int] = {}
    for j, b in enumerate(sel):
        lane.setdefault(b, j)
    return lane


def _leaf_pairs(dst, src):
    """(dst, src) tensor pairs of two trees of the same structure."""
    if isinstance(dst, dict):
        for k in dst:
            yield from _leaf_pairs(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            yield from _leaf_pairs(a, b)
    else:
        yield dst, src


def gather_slots(cache, idx: torch.Tensor):
    """The dense sub-cache of slots `idx` (long, (w,)): segment leaves
    (L, B, C, ...) gathered on the batch axis, "index" (B,) with them
    (copies; the JAX `_gather_slots`)."""
    return {"segments": tree_map(lambda t: t.index_select(1, idx), cache["segments"]),
            "index": cache["index"].index_select(0, idx)}


def scatter_slots(cache, sub, idx: torch.Tensor, n: int) -> None:
    """Write the first `n` lanes of sub-cache `sub` back into slots
    idx[:n] of `cache`, in place (the JAX `_scatter_slots`; padding lanes
    past n repeat a real slot and are not written)."""
    for full, part in _leaf_pairs(cache["segments"], sub["segments"]):
        full.index_copy_(1, idx[:n], part[:, :n].to(full.dtype))
    cache["index"].index_copy_(0, idx[:n], sub["index"][:n].to(cache["index"].dtype))


def _local_heads(mesh, cfg: ModelConfig, tree: Params) -> Params:
    """A zero KV tree at this rank's KV heads (`sharding.kv_head_specs`)."""
    return sharding.place(mesh, tree, sharding.kv_head_specs(
        mesh, tree, cfg.kv_heads, n_heads=cfg.n_heads))


@dataclasses.dataclass(frozen=True)
class Lanes:
    """How this rank runs one step over the global lanes `sel` (slot ids,
    padding lanes repeating a slot): `slots` (rows,) the global slot each
    local row decodes, `idx` their local slot indices (long), the first
    `n` rows real (the rest stand in for a data row with fewer lanes and
    are never written back), `rows` (rows,) the global lane each local row
    stands for, `order` (W,) the W lanes' rows among the rows gathered
    from every data rank (rank-major; None: unsplit, the local rows are
    the lanes)."""
    slots: list
    idx: torch.Tensor
    n: int
    rows: torch.Tensor
    order: torch.Tensor | None = None


class DenseKVState:
    """Transformer dense KV rectangles {"segments": [{"k", "v": (L, B, C,
    Hkv, hd)} or MLA's {"latent": (L, B, C, kv_rank + rope_dim)}],
    "index": (B,)}, C the ring length of a sliding-window model, updated
    in place.

    Prefill runs each prompt at its exact length and splices the batch-1
    cache into slot b (on the batch axis always: the JAX `_tree_set_slot`
    finds no batch axis with one slot).  With `compact` and
    `decode_batch < max_batch` the active slots are gathered into a
    sub-cache of width `decode_batch` (padding lanes repeat the first
    active slot), decoded and the active lanes scattered back; otherwise
    every slot decodes at full width and the slots that were not active
    have their index rewound by one batched update.

    `quantized`: the rectangles are int8 codes with one float32 scale per
    (layer, slot, kv head) over the whole rectangle, per (layer, slot)
    for latents (`self.scales`).
    Decode is then always the gathered form: the selected slots are
    dequantized to the model dtype, decoded, their positions past the old
    index zeroed and the whole rectangles requantized with fresh scales,
    as the JAX `_dense_quant_step_fn` does (no full-width rewind over int8
    codes).

    After `place(mesh)` the bf16 / f32 rectangles may be split over
    "data" (`split`, see the module docstring): "rows", this data row
    holds slots [lo, lo + rows) and decodes the step's lanes it holds
    (`step_lanes`: at a fixed width a row, min(rows, lanes), so every
    collective has one size on every rank; a row with no lane decodes a
    stand-in row it never writes back), or "seq", each data row holds
    its block of the one slot's cache length.  `length`: the axes the
    cache length splits over ("model" where `cache_specs` puts it there,
    the DP axes under "seq"), each rank holding its block."""

    kind = "dense"
    paged = False
    pool = None
    buckets: tuple = ()
    mesh = None
    split = None        # "rows" | "seq" | None (see place)
    length = None       # the axes the cache length splits over (see place)

    def __init__(self, mcfg: ModelConfig, max_batch: int, max_len: int, *,
                 decode_batch: int, compact: bool, device: torch.device,
                 quantized: bool = False):
        self.mcfg = mcfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.decode_batch = decode_batch
        self.compact = compact
        self.capacity = max_len
        self.device = device
        self.quantized = quantized
        self.cache = api.init_cache(mcfg, max_batch, max_len, device=device)
        self.cache["index"] = torch.zeros((max_batch,), dtype=torch.int32,
                                          device=device)
        self.scales = None
        if quantized:
            self.cache["segments"] = tree_map(
                lambda a: torch.zeros(a.shape, dtype=torch.int8, device=device),
                self.cache["segments"])
            self.scales = kvq.scale_struct(self.cache["segments"])

    def place(self, mesh) -> None:
        """The rectangles at this rank's blocks of `sharding.cache_specs`
        (KV heads, or the cache length, over "model"; the slots, or one
        slot's length, over "data"); int8 rectangles and scales at the
        local KV heads only, every slot whole (see the module
        docstring)."""
        if self.quantized:
            self.cache["segments"] = _local_heads(mesh, self.mcfg, self.cache["segments"])
            self.scales = _local_heads(mesh, self.mcfg, self.scales)
            return
        specs = sharding.cache_specs(mesh, self.cache, self.mcfg.kv_heads,
                                     self.max_batch, self.mcfg.cache_seq_shard,
                                     n_heads=self.mcfg.n_heads)
        self.cache = sharding.place(mesh, self.cache, specs)
        self.mesh = mesh
        self.split = sharding.dense_split(mesh, specs)
        self.length = sharding.length_axes(mesh, specs)
        self._dp = sharding.dp_axes(mesh)
        self._row = mesh.axis_rank(self._dp) if self.split else 0
        self._block = mesh.axis_rank(self.length) if self.length else 0
        self._per_row = self.cache["index"].shape[0]

    def local_slot(self, b: int) -> int | None:
        """Slot b's index in this rank's rectangles (None: another data
        row holds it; under SP every row holds its block of slot 0)."""
        if self.split != "rows":
            return b
        lo = self._row * self._per_row
        return b - lo if lo <= b < lo + self._per_row else None

    def step_lanes(self, sel: list[int]) -> Lanes:
        """The local rows of one step over the global lanes `sel` (slot ids
        in JAX's lane order): every lane when the slots are whole; with
        the slots split over "data", the distinct slots this row holds in
        their lane order, padded to min(rows, len(sel)) rows with a
        stand-in (this row's first slot, never written back), and where
        every lane sits among the rows gathered from every data row."""
        dev = self.device
        if self.split != "rows":
            return Lanes(list(sel), torch.as_tensor(sel, dtype=torch.long, device=dev),
                         len(dict.fromkeys(sel)), torch.arange(len(sel), device=dev))
        per = self._per_row
        width = min(per, len(sel))
        held: dict[int, list[int]] = {}
        for b in dict.fromkeys(sel):
            held.setdefault(b // per, []).append(b)
        lane = _lane_map(sel)
        order = [(b // per) * width + held[b // per].index(b) for b in sel]
        mine = held.get(self._row, [])
        lo = self._row * per
        slots = mine + [lo] * (width - len(mine))
        rows = [lane[b] for b in mine] + [0] * (width - len(mine))
        return Lanes(slots, torch.as_tensor([b - lo for b in slots], dtype=torch.long,
                                            device=dev),
                     len(mine), torch.as_tensor(rows, dtype=torch.long, device=dev),
                     torch.as_tensor(order, dtype=torch.long, device=dev))

    def split_run(self, lanes: Lanes):
        """The context a step over `lanes` runs its model calls in: this
        row's slots split over "data" (with the lanes), the cache length
        split over "data" (SP) or over "model" (`length`), or the
        enclosing mesh as it is."""
        kw: dict = {}
        if self.split == "rows":
            kw = dict(data_split=True, lanes=(lanes.order, lanes.rows))
        elif self.split == "seq":
            kw = dict(seq_split=True)
        if self.length == ("model",):
            kw["seq_split"] = "model"
        return sharding.use_mesh(self.mesh, **kw) if kw else contextlib.nullcontext()

    def gather_lanes(self, out: torch.Tensor, lanes: Lanes) -> torch.Tensor:
        """A step's per-row output (rows, ...) as every lane's (W, ...) in
        lane order, on every rank: one all_gather over the mesh's DP axes
        where the slots are split, else `out` itself."""
        if self.split != "rows":
            return out
        return coll.all_gather(out, self.mesh, self._dp, dim=0).index_select(0, lanes.order)

    def prefill(self, params: Params, b: int, seq: np.ndarray,
                frames=None) -> torch.Tensor:
        """Prefill `seq` (its batch-1 cache made on every rank) and splice
        it into slot b: the owning data row alone where the slots split,
        each row's block of its length under SP."""
        toks = torch.as_tensor(np.asarray(seq)[None, :], dtype=torch.long,
                               device=self.device)
        last, cache1 = api.prefill(self.mcfg, params, {"tokens": toks},
                                   self.max_len)
        if self.split is not None or self.length is not None:
            at = self.local_slot(b)
            if at is None:
                return last
            for dst, src in _leaf_pairs(self.cache["segments"], cache1["segments"]):
                clen = dst.shape[2]       # a split length: this rank's block
                off = self._block * clen
                dst[:, at].copy_(src[:, 0, off:off + clen])
            self.cache["index"][at] = len(seq)
            return last
        if self.quantized:
            for (dst, src), (dsc, _) in zip(
                    _leaf_pairs(self.cache["segments"], cache1["segments"]),
                    _leaf_pairs(self.scales, cache1["segments"])):
                q, sc = kvq.quantize_block(src, 2)
                dst[:, b].copy_(q[:, 0])
                dsc[:, b].copy_(sc[:, 0])
        else:
            for dst, src in _leaf_pairs(self.cache["segments"], cache1["segments"]):
                dst[:, b].copy_(src[:, 0])
        self.cache["index"][b] = len(seq)
        return last

    def _decode_quantized(self, params: Params, next_token: np.ndarray,
                          active: list[int]):
        """The int8 step: always gathered at width decode_batch, so only
        the selected slots dequantize and requantize."""
        sel = active + [active[0]] * (self.decode_batch - len(active))
        idx = torch.as_tensor(sel, dtype=torch.long, device=self.device)
        sub_idx = self.cache["index"].index_select(0, idx)
        dt = self.mcfg.tdtype
        segs = [{k: kvq.dequantize_block(q.index_select(1, idx),
                                         self.scales[i][k].index_select(1, idx), dt)
                 for k, q in seg.items()}
                for i, seg in enumerate(self.cache["segments"])]
        logits, new = api.decode_step(
            self.mcfg, params,
            torch.as_tensor(next_token[np.asarray(sel)], dtype=torch.long,
                            device=self.device),
            {"segments": segs, "index": sub_idx})
        for i, seg in enumerate(new["segments"]):
            for k, x in seg.items():     # (L, w, C, Hkv, hd)
                # live after this step: positions <= the old index
                q, sc = kvq.requantize(x, sub_idx.long() + 1, 2)
                self.cache["segments"][i][k].index_copy_(1, idx, q)
                self.scales[i][k].index_copy_(1, idx, sc)
        self.cache["index"].index_copy_(0, idx, new["index"].to(torch.int32))
        return logits, _lane_map(sel)

    def _tokens_of(self, next_token: np.ndarray, slots: list[int]) -> torch.Tensor:
        return torch.as_tensor(next_token[np.asarray(slots)], dtype=torch.long,
                               device=self.device)

    def decode(self, params: Params, next_token: np.ndarray,
               active: list[int]):
        if self.quantized:
            return self._decode_quantized(params, next_token, active)
        if self.compact and self.decode_batch < self.max_batch:
            sel = active + [active[0]] * (self.decode_batch - len(active))
            lanes = self.step_lanes(sel)
            with self.split_run(lanes):
                logits, new = api.decode_step(
                    self.mcfg, params, self._tokens_of(next_token, lanes.slots),
                    gather_slots(self.cache, lanes.idx))
            # padding lanes repeat active[0] with identical results: only
            # the active lanes are written back
            scatter_slots(self.cache, new, lanes.idx, lanes.n)
            return self.gather_lanes(logits, lanes), _lane_map(sel)
        # full width: every slot this rank holds, in slot order
        lanes = self.step_lanes(list(range(self.max_batch)))
        with self.split_run(lanes):
            logits, new = api.decode_step(
                self.mcfg, params, self._tokens_of(next_token, lanes.slots), self.cache)
        self.cache = new
        # every slot advanced; those that were not active step back in one
        # batched update
        inactive = [at for at in (self.local_slot(b) for b in range(self.max_batch)
                                  if b not in active) if at is not None]
        if inactive:
            self.cache["index"][torch.as_tensor(inactive, device=self.device)] -= 1
        return self.gather_lanes(logits, lanes), {b: b for b in active}

    def release(self, b: int) -> None:
        pass


class PagedKVState:
    """Block-paged KV: PagePool + bucketed prefill + gathered decode (or,
    with attn_impl "flash", decode from the pool itself); `quantized`:
    int8 pages with per-(layer, page, kv head) scales."""

    kind = "paged"
    paged = True
    cache = None

    def __init__(self, mcfg: ModelConfig, max_batch: int, max_len: int, *,
                 decode_batch: int, compact: bool, page_size: int,
                 num_pages: int | None, bucket_min: int,
                 device: torch.device, quantized: bool = False):
        self.mcfg = mcfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.decode_batch = decode_batch
        self.compact = compact
        self.device = device
        self.quantized = quantized
        self.pool = paged_kv.PagePool(mcfg, max_batch, max_len,
                                      page_size=page_size,
                                      num_pages=num_pages, quant=quantized,
                                      device=device)
        self.buckets = paged_kv.prefill_buckets(max_len, bucket_min)
        self.capacity = paged_kv.pool_token_capacity(self.pool, max_len)

    def place(self, mesh) -> None:
        """The page pools (and int8 scales) at this rank's KV heads; the
        page dims never shard (the JAX `paged_cache_shardings`)."""
        pool = self.pool
        pool.segments = _local_heads(mesh, self.mcfg, pool.segments)
        if pool.scales is not None:
            pool.scales = _local_heads(mesh, self.mcfg, pool.scales)

    def prefill(self, params: Params, b: int, seq: np.ndarray,
                frames=None) -> torch.Tensor:
        """Bucket-padded prefill of `seq` into slot b's pages; returns
        the (1, 1, V) last-real-token logits."""
        plen = len(seq)
        bucket = paged_kv.bucket_for(plen, self.buckets)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = seq
        trow = self.pool.table_row(b, bucket // self.pool.page_size)
        last = paged_kv.paged_prefill(
            self.mcfg, params, torch.as_tensor(toks, device=self.device),
            plen, self.pool.segments, trow, self.pool.page_size,
            self.pool.scales)
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
            self.pool.index[sel_arr], self.pool.scales)
        # lengths are host-side numpy: advance them here
        self.pool.index[np.asarray(active)] += 1
        return logits, _lane_map(sel)

    def release(self, b: int) -> None:
        self.pool.release(b)


# -- recurrent (rglru / rwkv6) and encoder-decoder (whisper) -----------------


class _LayersState:
    """{"layers": [(B, ...)], "index": (B,)} caches, the batch on axis 0
    of every leaf, gathered and scattered per slot in place.

    Prefill runs each prompt at its exact length (no buckets, as in the
    JAX package) and splices the batch-1 cache into the slot (on axis 0
    always: the JAX `_tree_set_slot` finds no batch axis with one slot).
    Decode is always the gathered sub-batch form at width `decode_batch`:
    recurrent state advances irreversibly, so a slot that is not active
    must never run through the model.  Padding lanes repeat `active[0]`;
    only the active lanes are scattered back (the JAX state scatters the
    padding too, writing the same values again)."""

    paged = False
    pool = None
    buckets: tuple = ()

    def __init__(self, mcfg: ModelConfig, max_batch: int, max_len: int, *,
                 decode_batch: int, device: torch.device,
                 enc_len: int | None = None):
        self.mcfg = mcfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.decode_batch = decode_batch
        self.compact = True           # gathered decode is structural here
        self.capacity = max_len
        self.device = device
        self.enc_len = enc_len or max_len
        self.cache = api.init_cache(mcfg, max_batch, max_len, device=device,
                                    enc_len=self.enc_len)
        self.cache["index"] = torch.zeros((max_batch,), dtype=torch.int32,
                                          device=device)

    def _splice(self, b: int, cache1, plen: int) -> None:
        """Write a batch-1 cache into slot b and set its length."""
        for dst, src in _leaf_pairs(self.cache["layers"], cache1["layers"]):
            dst[b].copy_(src[0])
        self.cache["index"][b] = plen

    def _tokens(self, seq: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(seq)[None, :], dtype=torch.long,
                               device=self.device)

    def decode(self, params: Params, next_token: np.ndarray,
               active: list[int]):
        sel = active + [active[0]] * (self.decode_batch - len(active))
        idx = torch.as_tensor(sel, dtype=torch.long, device=self.device)
        sub = tree_map(lambda t: t.index_select(0, idx), self.cache)
        logits, new = api.decode_step(
            self.mcfg, params,
            torch.as_tensor(next_token[np.asarray(sel)], dtype=torch.long,
                            device=self.device), sub)
        n = len(active)
        for full, part in _leaf_pairs(self.cache, new):
            full.index_copy_(0, idx[:n], part[:n].to(full.dtype))
        return logits, _lane_map(sel)

    def release(self, b: int) -> None:
        pass

    def place(self, mesh) -> None:
        """The per-layer leaves at this rank's channels and heads; the
        slot axis stays whole."""
        layers = self.cache["layers"]
        self.cache["layers"] = sharding.place(
            mesh, layers, sharding.layer_state_specs(mesh, self.mcfg, layers))


class RecurrentState(_LayersState):
    """rglru conv + hidden state (and the ring KV of its attention
    layers) / rwkv6 wkv + token-shift state."""

    kind = "recurrent"

    def prefill(self, params: Params, b: int, seq: np.ndarray,
                frames=None) -> torch.Tensor:
        last, cache1 = api.prefill(self.mcfg, params,
                                   {"tokens": self._tokens(seq)}, self.max_len)
        self._splice(b, cache1, len(seq))
        return last


class CrossAttnState(_LayersState):
    """Whisper: the decoder's self KV and the encoder output's cross KV.
    A request's frame embeddings are padded with zeros or truncated to
    the fixed `enc_len` window, so every prefill encodes one window
    shape; a request without frames encodes a zero (silence) window."""

    kind = "cross_attn"

    def _fixed_frames(self, frames) -> torch.Tensor:
        out = np.zeros((1, self.enc_len, self.mcfg.d_model), np.float32)
        if frames is not None:
            f = np.asarray(frames, np.float32)
            if f.ndim == 3:
                f = f[0]
            take = min(f.shape[0], self.enc_len)
            out[0, :take] = f[:take]
        return torch.as_tensor(out, device=self.device)

    def prefill(self, params: Params, b: int, seq: np.ndarray,
                frames=None) -> torch.Tensor:
        last, cache1 = api.prefill(
            self.mcfg, params,
            {"embeds": self._fixed_frames(frames), "tokens": self._tokens(seq)},
            self.max_len)
        self._splice(b, cache1, len(seq))
        return last
