"""Speculative decoding (the port of `repro.serving.specdec`; Leviathan et
al., paper §6.2.1): a small draft model proposes k tokens, the target
verifies them in one batched forward.

* The reference loops: `spec_decode_greedy` equals target-only greedy
  decoding; `spec_decode_sampled` applies the p/q acceptance rule with an
  explicit CPU `torch.Generator` (JAX keys cannot be reproduced here, so
  its agreement with the JAX loop is in distribution only).  Both re-run
  full uncached forwards and serve as cross-checks.
* The live engine: `SpecDecodeEngine` co-locates draft and target in one
  `ServingEngine`, each with a dense per-slot KV cache; every decode tick
  runs k draft `decode_step`s (propose) and one target `decode_window`
  (verify) over the gathered active slots and lands 1 to k tokens a slot,
  token-exact against target-only greedy decoding.

On a mesh (`SpecDecodeEngine(mesh=)`) the target is sharded (its params
are this rank's blocks, its KV placed by the dense rule: heads over
"model", the slots, or one slot's length, over "data"; each data row
verifies its own slots and the rows' logits are gathered over "data")
and the draft is replicated: every rank holds the whole draft and its
whole KV and runs it unsharded, as the JAX engine leaves the draft
unplaced.  Rank 0's drafts are broadcast
before each verify and its accepted tokens and counts after it, so the
ranks cannot drift.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.bridge import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import api, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding
from repro_torch.spans import span

from .engine import Request, ServingEngine
from .resilience import logits_finite
from .state import DenseKVState, _lane_map, gather_slots, scatter_slots

Params = Any
Forward = Callable[[torch.Tensor], torch.Tensor]    # tokens (1, S) -> logits (1, S, V)

SPEC_K = 4    # the JAX knob registry's default draft window


@dataclasses.dataclass
class SpecStats:
    iterations: int = 0
    proposed: int = 0
    accepted: int = 0
    bonus: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)

    @property
    def tokens_per_iteration(self) -> float:
        return (self.accepted + self.bonus) / max(self.iterations, 1)


def _row(seq: list[int], device: torch.device) -> torch.Tensor:
    return torch.as_tensor([seq], dtype=torch.long, device=device)


def spec_decode_greedy(target_fwd: Forward, draft_fwd: Forward, prompt: np.ndarray, *,
                       k: int = 5, max_new_tokens: int = 32, device=None
                       ) -> tuple[np.ndarray, SpecStats]:
    """Greedy speculative decoding; the output equals the target's greedy
    decode.  The forwards take (1, S) token tensors on `device`."""
    dev = resolve_device(device)
    toks = [int(t) for t in prompt]
    stats = SpecStats()
    while len(toks) - len(prompt) < max_new_tokens:
        stats.iterations += 1
        d = list(toks)
        for _ in range(k):
            d.append(int(draft_fwd(_row(d, dev))[0, -1].argmax()))
        proposal = d[len(toks):]
        stats.proposed += k
        # the target's choice at position len(toks) - 1 + i predicts proposal[i]
        choice = target_fwd(_row(d, dev))[0].argmax(-1).tolist()
        base = len(toks) - 1
        n_accept = 0
        while n_accept < k and choice[base + n_accept] == proposal[n_accept]:
            n_accept += 1
        stats.accepted += n_accept
        toks.extend(proposal[:n_accept])
        toks.append(int(choice[base + n_accept]))      # the bonus token
        stats.bonus += 1
    new = toks[len(prompt):len(prompt) + max_new_tokens]
    return np.asarray(new, np.int32), stats


def spec_decode_sampled(target_fwd: Forward, draft_fwd: Forward, prompt: np.ndarray,
                        generator: torch.Generator, *, k: int = 5,
                        max_new_tokens: int = 32, temperature: float = 1.0,
                        device=None) -> tuple[np.ndarray, SpecStats]:
    """Stochastic speculative sampling with the p/q acceptance rule,
    distributed as sampling from the target alone.  Every draw comes from
    `generator`, a CPU generator: the loop samples on the host."""
    dev = resolve_device(device)
    toks = [int(t) for t in prompt]
    stats = SpecStats()

    def probs(fwd, seq):
        lg = fwd(_row(seq, dev))[0].float().cpu()
        return torch.softmax(lg / temperature, dim=-1)

    def draw(p):
        return int(torch.multinomial(p.clamp_min(0), 1, generator=generator))

    while len(toks) - len(prompt) < max_new_tokens:
        stats.iterations += 1
        d = list(toks)
        qs = []
        for _ in range(k):
            q = probs(draft_fwd, d)[-1]
            t = draw(q)
            qs.append((t, q))
            d.append(t)
        stats.proposed += k
        p_all = probs(target_fwd, d)
        base = len(toks) - 1
        n_accept, bonus = 0, None
        for i, (t, q) in enumerate(qs):
            p = p_all[base + i]
            r = float(torch.rand((), generator=generator))
            if r < min(1.0, float(p[t]) / max(float(q[t]), 1e-30)):
                n_accept += 1
                continue
            resid = (p - q).clamp_min(0.0)      # resample from max(0, p - q)
            bonus = draw(resid if float(resid.sum()) > 0 else p)
            break
        stats.accepted += n_accept
        toks.extend(t for t, _ in qs[:n_accept])
        if bonus is None:                        # all accepted: from the target
            bonus = draw(p_all[base + k])
        toks.append(bonus)
        stats.bonus += 1
    new = toks[len(prompt):len(prompt) + max_new_tokens]
    return np.asarray(new, np.int32), stats


# -- live in-engine speculative decoding --------------------------------------


class SpecKVState(DenseKVState):
    """The target's dense KV rectangles (compact) with the draft's beside
    them (`draft`): a prefill fills both, so draft and target share every
    slot's context.  `place` shards the target's alone (the dense rule);
    the draft runs outside any mesh."""

    def __init__(self, mcfg: ModelConfig, draft_cfg: ModelConfig, draft_params: Params,
                 max_batch: int, max_len: int, *, decode_batch: int,
                 device: torch.device):
        super().__init__(mcfg, max_batch, max_len, decode_batch=decode_batch,
                         compact=True, device=device)
        self.draft_params = draft_params
        self.draft = DenseKVState(draft_cfg, max_batch, max_len,
                                  decode_batch=decode_batch, compact=True, device=device)

    def prefill(self, params: Params, b: int, seq: np.ndarray,
                frames=None) -> torch.Tensor:
        last = super().prefill(params, b, seq)
        with sharding.use_mesh(None):
            self.draft.prefill(self.draft_params, b, seq)
        return last


class SpecDecodeEngine(ServingEngine):
    """A `ServingEngine` whose decode tick is a propose/verify iteration.

    Greedy only (`submit` rejects temperature > 0).  Each tick the draft
    decodes k steps from every active slot's pending token (propose), the
    target verifies the window [pending, d_1 .. d_{k-1}] in one
    `decode_window` (verify), the longest matching prefix, capped at k - 1
    so the draft cache holds every consumed position, is accepted, and
    the target's own choice at the divergence is the bonus token: the
    stream equals target-only greedy decoding.  Both caches then rewind
    their index to the consumed positions (stale KV past it is masked and
    later overwritten).  Non-finite verify logits set
    `health["nan_detected"]` and emit nothing.  Plain-attention
    transformer target and draft (`transformer.window_supported`), dense
    un-quantized KV.  `mesh`: the target's params are this rank's blocks
    and `draft_params` the whole draft (see the module docstring)."""

    def __init__(self, mcfg: ModelConfig, params: Params, draft_cfg: ModelConfig,
                 draft_params: Params, *, k: int = SPEC_K, **kw):
        if not transformer.window_supported(mcfg):
            raise ValueError(
                "SpecDecodeEngine needs a plain-attention transformer target "
                f"(family={mcfg.family}, use_mla={mcfg.use_mla}, window={mcfg.window})")
        if not transformer.window_supported(draft_cfg):
            raise ValueError("draft config must be a plain-attention transformer too")
        if k < 2:
            raise ValueError(f"spec-decode needs k >= 2, got {k}")
        self.k = k
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        kw["paged"] = False
        kw["kv_quant"] = False
        super().__init__(mcfg, params, **kw)
        # the verify writes k positions from the slot's length on: finish a
        # slot before the window would pass the cache
        self._headroom = k
        self.draft_state = self.state.draft
        self.spec_stats = SpecStats()

    def _new_state(self, **_) -> SpecKVState:
        """Target and draft KV side by side, in place of the base engine's
        target-only rectangles."""
        self.draft_params = tree_map(
            lambda t: t.to(self.device) if isinstance(t, torch.Tensor) else t,
            self.draft_params)
        return SpecKVState(self.mcfg, self.draft_cfg, self.draft_params, self.max_batch,
                           self.max_len, decode_batch=self.decode_batch, device=self.device)

    def submit(self, req: Request) -> bool:
        if req.temperature > 0.0:
            raise ValueError(
                "SpecDecodeEngine is greedy-only (temperature=0); "
                f"request {req.rid} has temperature={req.temperature}")
        return super().submit(req)

    def _advance(self, active: list[int]) -> bool:
        """One propose/verify iteration over the gathered active slots
        (padding lanes repeat active[0]; only the active lanes are
        written back)."""
        k = self.k
        sel = active + [active[0]] * (self.decode_batch - len(active))
        self._drain()
        with span("mz.decode"):
            idx = torch.as_tensor(sel, dtype=torch.long, device=self.device)
            tok = torch.as_tensor(self.next_token[np.asarray(sel)], dtype=torch.long,
                                  device=self.device)
            dsub = gather_slots(self.draft_state.cache, idx)
            base = dsub["index"].clone()
            drafts, t = [], tok
            for _ in range(k):             # the draft runs whole on every rank
                logits, dsub = api.decode_step(self.draft_cfg, self.draft_params, t, dsub)
                t = logits[:, -1].argmax(-1, keepdim=True)
                drafts.append(t)
            drafts = torch.cat(drafts, 1)                                # (w, k)
            if self.mesh is not None:        # the verify window must be rank 0's
                drafts = coll.broadcast(drafts, self.mesh)
            # the target verifies this rank's lanes (its data row's slots where
            # they split over "data") and every rank reads every lane's logits
            lanes = self.state.step_lanes(sel)
            tsub = gather_slots(self.state.cache, lanes.idx)
            window = torch.cat([tok, drafts[:, :-1]], 1)                 # (w, k)
            with sharding.use_mesh(self.mesh), self.state.split_run(lanes):
                logits, tsub = api.decode_window(self.mcfg, self.params,
                                                 window.index_select(0, lanes.rows), tsub)
            logits = self.state.gather_lanes(logits, lanes)
        if self.guard_nan and not self._synced(logits_finite, logits):
            self.health["nan_detected"] = True
            self.stats["nan_steps"] += 1
            return False                 # the sub-caches are dropped
        choice = logits.argmax(-1)                                   # (w, k)
        # accepted drafts a lane: the matching prefix, capped at k - 1
        match = (drafts[:, :k - 1] == choice[:, :k - 1]).long().cumprod(1)
        acc = torch.cat([match.sum(1, keepdim=True), choice], 1)     # (w, 1 + k)
        if self.mesh is not None:        # rank 0's accepted tokens and counts
            acc = coll.broadcast(acc, self.mesh)
        drafts_np, acc_np = self._synced(lambda: (drafts.cpu().numpy(), acc.cpu().numpy()))
        lane = _lane_map(sel)
        consumed = np.zeros(len(sel), np.int64)
        for b in active:
            j = lane[b]
            req = self.slots[b]
            n = int(acc_np[j, 0])
            emitted = [int(x) for x in drafts_np[j, :n]] + [int(acc_np[j, 1 + n])]
            self.spec_stats.iterations += 1
            self.spec_stats.proposed += k - 1
            self.spec_stats.accepted += n
            self.spec_stats.bonus += 1
            # budget / eos truncation: a cut always finishes the slot, so
            # the dropped tail's KV is never read
            out = emitted[:req.max_new_tokens - len(req.out_tokens)]
            if self.eos_id in out:
                out = out[:out.index(self.eos_id) + 1]
            req.out_tokens.extend(out)
            self.next_token[b, 0] = out[-1]
            self.stats["tokens_out"] += len(out)
            consumed[j] = len(out)
            if len(req.out_tokens) >= req.max_new_tokens or out[-1] == self.eos_id:
                self._finish(b, "eos" if out[-1] == self.eos_id else "max_new_tokens")
        # rewind both caches' index to the consumed positions
        index = base + torch.as_tensor(consumed, device=self.device).to(base.dtype)
        n = len(active)
        scatter_slots(self.state.cache, {"segments": tsub["segments"],
                                         "index": index.index_select(0, lanes.rows)},
                      lanes.idx, lanes.n)
        scatter_slots(self.draft_state.cache,
                      {"segments": dsub["segments"], "index": index}, idx, n)
        return True


def shared_trunk_draft(cfg: ModelConfig, params: Params, n_draft: int
                       ) -> tuple[ModelConfig, Params]:
    """A draft = the target's first `n_draft` layers with the shared
    embedding, final norm and head (views of the target's tensors, no
    copy).  Single-segment transformers; the port runs layers in a loop,
    so a config with scan_layers set is taken too (the JAX package
    refuses it)."""
    if cfg.family != "transformer" or len(params["segments"]) != 1:
        raise ValueError("shared_trunk_draft needs a single-segment transformer")
    if not 0 < n_draft < cfg.n_layers:
        raise ValueError(f"n_draft must be in (0, {cfg.n_layers})")
    (kind, layers), = params["segments"][0].items()
    dcfg = cfg.replace(n_layers=n_draft)
    dparams = {**{k: v for k, v in params.items() if k != "segments"},
               "segments": [{kind: tree_map(lambda a: a[:n_draft], layers)}]}
    return dcfg, dparams


def high_tar_pair(cfg: ModelConfig, params: Params, n_draft: int
                  ) -> tuple[Params, ModelConfig, Params]:
    """(target params, draft config, draft params) whose acceptance is 1
    by construction: the target's residual writes past layer `n_draft`
    (`attn.wo`, `mlp.w_out`) are zero, so the deep target computes the
    function of its `n_draft`-layer shared-trunk draft at full depth's
    cost.  Isolates the serving-side gain of k tokens a verify."""
    dcfg, dparams = shared_trunk_draft(cfg, params, n_draft)
    (kind, layers), = params["segments"][0].items()
    layers = dict(layers)
    for block, name in (("attn", "wo"), ("mlp", "w_out")):
        sub = dict(layers[block])
        w = sub[name].clone()
        w[n_draft:] = 0
        sub[name] = w
        layers[block] = sub
    return {**params, "segments": [{kind: layers}]}, dcfg, dparams
