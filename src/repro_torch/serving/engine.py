"""Serving engine of the port (from `repro.serving.engine`): slot-based
continuous batching over the block-paged KV pool (plain transformers),
the dense KV rectangles (every other transformer), the gathered
recurrent state (rglru, rwkv6) or whisper's cross-attention state.

A fixed pool of `max_batch` slots decodes in lock step; finished slots
are refilled by prefilling queued requests into them.  The scheduling is
the JAX engine's, rule for rule, so the same trace gives the same token
streams and the same `stats` and `finish_reason`s:

* admission drains the queue resumed-first, then earliest deadline, then
  submission order; requests that cannot meet their deadline at the
  measured per-step pace are shed ("shed"), prompts that cannot decode
  one token inside the cache are rejected ("rejected"), and a bounded
  queue sheds new submissions;
* `decode_batch < max_batch` decodes a compacted sub-batch in slot-id
  rotation (`compact=False`: the full-width emulation);
* under page pressure (paged state only) the youngest-admitted slot is
  preempted and requeued at the front, to be resumed by re-prefilling
  its tokens; a lone slot that exhausts the pool finishes with
  "capacity";
* a slot whose next KV write would pass the cache finishes with
  "length";
* every decode's logits pass an all-finite guard before sampling: a
  non-finite step emits nothing and sets `health["nan_detected"]`.

Switches are constructor arguments with the JAX knob registry's
defaults (paged on, page size 16, bucket minimum 16, compact decode on,
NaN guard on, deadline shedding on, queue bound 0 = unbounded).  The
state is chosen as the JAX engine chooses it: `PagedKVState` when paged
serving applies (a transformer with no sliding window and no MoE),
`DenseKVState` for every other transformer (`paged=False` included),
`CrossAttnState` for whisper (each request's `frames` encoded at
admission over an `enc_len` window, default `max_len`), `RecurrentState`
for rglru and rwkv6 (the last two always compact).  `kv_quant`
stores KV in int8 with per-head scales (`serving/quant.py`), resolved as
the JAX engine resolves it (`_kv_quant_mode`): any truthy value
quantizes a paged engine's pool, the value "dense" a non-paged
transformer's rectangles (no sliding window); the resolved mode is
`engine.kv_quant_mode`.

`mesh` (a `parallel.mesh.Mesh`, one engine a rank, every rank given
the same requests) serves a transformer with tensor parallelism:
`params` are this rank's blocks of the weights (`api.init_params(mesh=)`
draws them, `parallel.sharding.shard_params` cuts them out of a whole
tree; a whole tree is refused), the engine places its state (`place`:
the local KV heads; a dense bf16 / f32 state's slots, or one slot's
cache length, over "data", as JAX's `cache_shardings`) and runs prefill
and decode inside `sharding.use_mesh`; a data-split state decodes each
data row's own slots and gathers the rows' logits over the engine
mesh's own data group (a cluster replica's, never its parent's), so
every rank samples from the same logits.  Every rank runs the same
scheduler; each sampled token, and each deadline shedding verdict (the
only decision read off the host clock), is rank 0's, broadcast, so the
ranks cannot drift.  Any family takes a mesh.  `hold` (a transformer's):
how `params` hold the weights (`sharding.HOLDS`; "fsdp" holds FSDP's
blocks, and each layer gathers its TP blocks while it runs).
`mesh=None` is the single-device path, unchanged.

Every mark and deadline verdict reads `engine.clock` (default
`time.monotonic`).  A cluster on a mesh sets it to the clock its ranks
agree on and sets `self_paced` False: it then feeds the engine's step
pace (`observe_step`) from that clock, so every rank's deadline
verdicts rest on the same numbers.

Beside the scheduling counts, `stats` holds `occupied_slot_steps` (live
slots summed over decode steps), `steps` (`step()` calls), `step_us`
(host µs inside them) and `sync_wait_us` (host µs waiting on the
device), each read off `engine.clock`; `Request.t_admit` marks a
request's first admission.  The host waits on the device only in
`_synced`: the NaN guard, the sampled tokens, a mesh's agreement, and a
drain before each state call (`_drain`, on a CUDA device: the call's
first copy from host memory would wait there anyway), so `step_us` less
`sync_wait_us` is the host's own time.  Under `torch.profiler` the engine
opens `mz.*` spans (`repro_torch.spans`) around the step, the admission,
each prefill (named with its request's id), the decode and each wait.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.bridge import tree_to
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding
from repro_torch.spans import span

from . import paged as paged_kv
from .resilience import logits_finite
from .sampling import sample
from .state import CrossAttnState, DenseKVState, PagedKVState, RecurrentState

Params = Any


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    # SLO deadline in seconds from t_submit; None = no deadline
    deadline_s: float | None = None
    # encoder frame embeddings (F, d_model) (whisper; None encodes a
    # zero window); other families ignore them
    frames: np.ndarray | None = None
    # cluster routing tag (None = any replica)
    model: str | None = None
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: str | None = None
    # wall-clock marks for TTFT/TPOT accounting (monotonic seconds)
    t_submit: float | None = None
    t_admit: float | None = None  # first admission (prefill start)
    t_first: float | None = None
    t_done: float | None = None
    admit_seq: int = -1           # admission order (preemption picks max)
    requeues: int = 0


def _kv_quant_mode(kv_quant, paged: bool, mcfg: ModelConfig) -> str:
    """The engine's KV-quant mode: "paged" (int8 page pool), "dense" (int8
    dense rectangles) or "" (off).  Any truthy value quantizes a paged
    engine; the explicit value "dense" also covers a non-paged transformer
    with no sliding window (the stale-position zeroing assumes slot j
    holds position j).  The JAX engine's rule."""
    mode = str(kv_quant).strip().lower()
    if mode in ("0", "", "false", "no", "off", "none"):
        return ""
    if paged:
        return "paged"
    if mode == "dense" and mcfg.family == "transformer" and not mcfg.window:
        return "dense"
    return ""


class ServingEngine:
    def __init__(self, mcfg: ModelConfig, params: Params, *,
                 max_batch: int = 4, max_len: int = 512,
                 decode_batch: int | None = None, eos_id: int = -1,
                 compact: bool = True, paged: bool = True,
                 page_size: int = 16, num_pages: int | None = None,
                 bucket_min: int = 16, kv_quant: bool | str = False,
                 enc_len: int | None = None,
                 queue_bound: int = 0, guard_nan: bool = True,
                 shed_deadlines: bool = True, seed: int = 0,
                 device: str | torch.device | None = None, mesh=None,
                 hold: str = "tp"):
        self.mesh = mesh
        self.hold = hold
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        # paged + bucketed serving is exact only for the plain transformer
        # cache (no sliding-window ring, no MoE router) — paged_supported
        self.paged = paged and paged_kv.paged_supported(mcfg)
        self.enc_len = enc_len
        self.kv_quant_mode = _kv_quant_mode(kv_quant, self.paged, mcfg)
        self.mcfg = mcfg
        self.params = tree_to(params, self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.decode_batch = decode_batch or max_batch
        # recurrent and cross-attention state cannot be rewound: their
        # decode always compacts
        self.compact = compact if mcfg.family == "transformer" else True
        self._next_slot = 0           # rotation cursor: a SLOT ID
        self.eos_id = eos_id
        self._admit_counter = 0
        self._headroom = 1            # KV positions one decode step writes
        self.queue_bound = queue_bound
        self.guard_nan = guard_nan
        self.shed_deadlines = shed_deadlines
        self.health = {"nan_detected": False}
        self._est_step_s = 0.0        # EWMA of step wall time
        self.clock = time.monotonic
        self.self_paced = True
        self.state = self._new_state(page_size=page_size, num_pages=num_pages,
                                     bucket_min=bucket_min)
        if mesh is not None:
            sharding.check_shards(mcfg, self.params, mesh, hold)
            self.state.place(mesh, hold)
        self.pool = self.state.pool
        self.buckets = self.state.buckets
        self.capacity = self.state.capacity
        self.slots: list[Request | None] = [None] * max_batch
        self.queue: list[Request] = []
        self.next_token = np.zeros((max_batch, 1), np.int64)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = {"decode_steps": 0, "prefills": 0,
                      "tokens_out": 0, "occupied_slot_steps": 0,
                      "preemptions": 0, "rejected": 0,
                      "shed": 0, "nan_steps": 0,
                      "steps": 0, "step_us": 0, "sync_wait_us": 0}

    def _new_state(self, *, page_size: int, num_pages: int | None, bucket_min: int):
        """The decode state this engine serves from: the page pool, dense
        KV rectangles, cross-attention or recurrent state."""
        mcfg = self.mcfg
        if self.paged:
            return PagedKVState(
                mcfg, self.max_batch, self.max_len, decode_batch=self.decode_batch,
                compact=self.compact, page_size=page_size,
                num_pages=num_pages, bucket_min=bucket_min, device=self.device,
                quantized=self.kv_quant_mode == "paged")
        if mcfg.family == "transformer":
            return DenseKVState(
                mcfg, self.max_batch, self.max_len, decode_batch=self.decode_batch,
                compact=self.compact, device=self.device,
                quantized=self.kv_quant_mode == "dense")
        if mcfg.family == "whisper":
            return CrossAttnState(
                mcfg, self.max_batch, self.max_len, decode_batch=self.decode_batch,
                device=self.device, enc_len=self.enc_len)
        return RecurrentState(
            mcfg, self.max_batch, self.max_len, decode_batch=self.decode_batch,
            device=self.device)

    @property
    def cache(self):
        """The live model-state tree (None for paged engines), owned by
        the decode state; the chaos injection and tests read it."""
        return self.state.cache

    @property
    def queue_full(self) -> bool:
        return self.queue_bound > 0 and len(self.queue) >= self.queue_bound

    # -- request lifecycle --------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue a request; returns False when the bounded queue sheds it."""
        if req.t_submit is None:
            req.t_submit = self.clock()
        if self.queue_bound > 0 and len(self.queue) >= self.queue_bound:
            self._shed(req)
            return False
        self.queue.append(req)
        return True

    def _shed(self, req: Request) -> None:
        req.done = True
        req.finish_reason = "shed"
        req.t_done = self.clock()
        self.stats["shed"] += 1

    def _slot_pos(self, b: int) -> int:
        """Cache length of slot b = prompt + decoded-in KV (the newest
        sampled token's KV is written by its decode step, hence -1)."""
        req = self.slots[b]
        return len(req.prompt) + len(req.out_tokens) - 1

    def _finish(self, b: int, reason: str) -> None:
        req = self.slots[b]
        req.done = True
        if req.finish_reason is None:
            req.finish_reason = reason
        req.t_done = self.clock()
        self.slots[b] = None
        self.state.release(b)

    def _preempt(self, b: int) -> None:
        """Evict slot b under page pressure and requeue it at the front."""
        req = self.slots[b]
        self.slots[b] = None
        self.state.release(b)
        self.queue.insert(0, req)
        self.stats["preemptions"] += 1

    def _admission_key(self, j: int) -> tuple:
        req = self.queue[j]
        dl = req.deadline_s
        return (0 if req.out_tokens else 1,
                dl if dl is not None else float("inf"), j)

    def _deadline_infeasible(self, req: Request) -> bool:
        if not self.shed_deadlines or req.deadline_s is None:
            return False
        now = self.clock()
        remaining = (req.t_submit or now) + req.deadline_s - now
        left = max(req.max_new_tokens - len(req.out_tokens), 0)
        late = remaining <= 0 or (self._est_step_s > 0.0
                                  and self._est_step_s * left > remaining)
        return bool(self._agree([int(late)])[0])

    def _agree(self, values: list[int]) -> list[int]:
        """Rank 0's values on every rank of the mesh (as given without one)."""
        if self.mesh is None:
            return values
        t = torch.as_tensor(values, dtype=torch.long, device=self.device)
        return self._synced(torch.Tensor.tolist, coll.broadcast(t, self.mesh))

    def _run_model(self, fn, *args, **kw):
        """A state call (prefill or decode) under this engine's mesh."""
        with sharding.use_mesh(self.mesh, hold=self.hold):
            return fn(self.params, *args, **kw)

    def _next_admission(self) -> int | None:
        while self.queue:
            j = min(range(len(self.queue)), key=self._admission_key)
            req = self.queue[j]
            if self._deadline_infeasible(req):
                self.queue.pop(j)
                self._shed(req)
                continue
            return j
        return None

    def _sample_one(self, logits_row: torch.Tensor, req: Request) -> int:
        return int(sample(logits_row, self.generator,
                          temperature=req.temperature)[0])

    def _synced(self, fn, *args):
        """fn(*args), a read that waits on the device: an `mz.sync` span,
        its host time added to `stats["sync_wait_us"]`."""
        t0 = self.clock()
        with span("mz.sync"):
            out = fn(*args)
        self.stats["sync_wait_us"] += round((self.clock() - t0) * 1e6)
        return out

    def _drain(self) -> None:
        """Before a state call on a CUDA device: wait for the device in
        `_synced`.  The call's first copy from host memory (its tokens)
        would wait for the stream at the same point."""
        if self.device.type == "cuda":
            self._synced(torch.cuda.synchronize, self.device)

    def _admit(self) -> None:
        """Prefill queued requests into free slots (continuous batching)."""
        with span("mz.admit"):
            self._admit_slots()

    def _admit_slots(self) -> None:
        for b in range(self.max_batch):
            if self.slots[b] is not None or not self.queue:
                continue
            qi = self._next_admission()
            if qi is None:
                break
            req = self.queue[qi]
            resumed = bool(req.out_tokens)
            if resumed:
                # re-prefill everything but the newest token
                seq = np.concatenate([
                    np.asarray(req.prompt, np.int32),
                    np.asarray(req.out_tokens[:-1], np.int32)])
            else:
                seq = np.asarray(req.prompt, np.int32)
            plen = len(seq)
            if plen < 1 or plen + self._headroom > self.capacity:
                self.queue.pop(qi)
                req.done = True
                req.finish_reason = "rejected"
                req.t_done = self.clock()
                self.stats["rejected"] += 1
                continue
            # +1: the next decode writes KV at position plen
            if self.paged and not self.pool.ensure(b, plen + 1):
                break       # pool dry — wait for decode-side frees
            if req.t_admit is None:
                req.t_admit = self.clock()
            self._drain()
            with span("mz.prefill", f"rid={req.rid} len={plen}"):
                last = self._run_model(self.state.prefill, b, seq, frames=req.frames)
            self.queue.pop(qi)
            self.slots[b] = req
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            self.stats["prefills"] += 1
            if resumed:
                self.next_token[b, 0] = req.out_tokens[-1]
                continue
            tok = self._agree([self._synced(self._sample_one, last[0, -1:], req)])[0]
            req.out_tokens.append(tok)
            if req.t_first is None:
                req.t_first = self.clock()
            self.next_token[b, 0] = tok
            self.stats["tokens_out"] += 1
            if len(req.out_tokens) >= req.max_new_tokens or \
                    tok == self.eos_id:
                self._finish(b, "eos" if tok == self.eos_id
                             else "max_new_tokens")

    def _select_active(self, all_active: list[int]) -> list[int]:
        """Up to decode_batch slots in slot-id rotation."""
        if self.decode_batch >= len(all_active):
            return list(all_active)
        ordered = [b for b in all_active if b >= self._next_slot] + \
                  [b for b in all_active if b < self._next_slot]
        active = ordered[:self.decode_batch]
        self._next_slot = (active[-1] + 1) % self.max_batch
        return active

    # -- decode tick ---------------------------------------------------------
    def step(self) -> int:
        """One lock-step decode over active slots; returns #active."""
        if self.health["nan_detected"]:
            return 0
        t_step = self.clock()
        with span("mz.step"):
            n = self._step()
        dt = self.clock() - t_step
        self.stats["steps"] += 1
        self.stats["step_us"] += round(dt * 1e6)
        if n and self.self_paced:
            self.observe_step(dt)
        return n

    def _step(self) -> int:
        self._admit()
        live = [b for b, r in enumerate(self.slots) if r is not None]
        for b in list(live):
            if self._slot_pos(b) + self._headroom > self.capacity:
                self._finish(b, "length")
                live.remove(b)
        if self.paged:
            live = self._grow_pages(live)
        if not live:
            return 0
        active = self._select_active(live)
        if not self._advance(active):
            return 0
        self.stats["decode_steps"] += 1
        self.stats["occupied_slot_steps"] += len(live)
        return len(active)

    def observe_step(self, dt: float) -> None:
        """Fold one step's duration into the pace deadline shedding reads."""
        self._est_step_s = dt if self._est_step_s == 0.0 \
            else 0.8 * self._est_step_s + 0.2 * dt

    def _advance(self, active: list[int]) -> bool:
        """Decode the active slots one step, guard, sample, finish.
        Returns False when the NaN guard swallowed the step."""
        self._drain()
        with span("mz.decode"):
            logits, lane = self._run_model(self.state.decode, self.next_token, active)
        last = logits[:, -1]
        if self.guard_nan and not self._synced(logits_finite, last):
            # emit nothing from non-finite logits; flag for the watchdog
            self.health["nan_detected"] = True
            self.stats["nan_steps"] += 1
            return False
        greedy = self._synced(torch.Tensor.tolist, last.argmax(dim=-1))
        toks = self._agree([greedy[lane[b]] if self.slots[b].temperature <= 0.0
                            else self._synced(self._sample_one, last[lane[b]][None],
                                              self.slots[b])
                            for b in active])
        for b, tok in zip(active, toks):
            req = self.slots[b]
            req.out_tokens.append(tok)
            self.next_token[b, 0] = tok
            self.stats["tokens_out"] += 1
            if len(req.out_tokens) >= req.max_new_tokens or \
                    tok == self.eos_id:
                self._finish(b, "eos" if tok == self.eos_id
                             else "max_new_tokens")
        return True

    def _grow_pages(self, live: list[int]) -> list[int]:
        """Back every live slot's next KV write by a page, preempting the
        youngest-admitted slot under pool pressure."""
        for b in list(live):
            while b in live and \
                    not self.pool.ensure(b, self._slot_pos(b) + 1):
                victims = [v for v in live if v != b]
                if not victims:
                    self._finish(b, "capacity")
                    live.remove(b)
                else:
                    v = max(victims, key=lambda s: self.slots[s].admit_seq)
                    self._preempt(v)
                    live.remove(v)
        return live

    def run(self, max_steps: int = 10_000) -> None:
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            if self.health["nan_detected"]:
                break
            self.step()
            steps += 1
