"""SLO-aware resilience primitives for the serving cluster (the port of
`repro.serving.resilience`).

The pieces `serving.cluster.ServingCluster` threads through its step
loop:

* **NaN/Inf guard** — `logits_finite`, an all-finite reduction the engine
  runs on every decode's logits before sampling: a non-finite step sets
  the engine's ``health["nan_detected"]`` and emits nothing, and the
  cluster's watchdog quarantines the replica that same step.
* **`Watchdog`** — a replica that holds work (queued or in-flight
  requests) but has emitted no token for `stall_steps` cluster steps is
  quarantined like `kill_replica` (token-exact requeue of everything it
  held), as is a replica whose engine flagged non-finite logits.
* **`ChaosSchedule`** — a seeded, deterministic fault script (kill /
  restart / stall / unstall / nan events at fixed step offsets);
  `generate` draws one from a seed with one `np.random.default_rng`, so a
  seed gives the JAX package's events.
* **`inject_nan`** — the nan event: poisons one live KV page (its scales
  in an int8 pool), a dense slot's rectangles (their scales when int8) or
  a recurrent slot's state, in place, so the next decode over it gives
  non-finite logits.
* **goodput** — `goodput_tokens` counts only tokens of requests that
  finished within their deadline (no deadline: always counted).

Host-side and duck-typed against the engine and the cluster (no imports
from them), so both can import this module.  The JAX knobs are
arguments here, with the knobs' defaults (stall steps 50, NaN check on,
chaos seed 0).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.bridge import tree_map

STALL_STEPS = 50      # the JAX knob registry's defaults
CHAOS_SEED = 0

_DROPPED = ("shed", "poison", "rejected")


def logits_finite(logits: torch.Tensor) -> bool:
    """True iff every logit is finite — the decode-output health guard
    (one reduction on the device; the host reads one bool)."""
    return bool(torch.isfinite(logits).all())


def goodput_tokens(reqs) -> int:
    """Tokens of requests that completed within their deadline; shed,
    poison and rejected requests and late finishes count nothing."""
    total = 0
    for r in reqs:
        if r.t_done is None or r.finish_reason in _DROPPED:
            continue
        if r.deadline_s is not None and (r.t_done - r.t_submit) > r.deadline_s:
            continue
        total += len(r.out_tokens)
    return total


def goodput_violations(reqs) -> int:
    """Requests `goodput_tokens` would count despite having missed their
    deadline: an independent recount, zero unless the accounting is
    broken."""
    bad = 0
    for r in reqs:
        if r.t_done is None or r.finish_reason in _DROPPED or r.deadline_s is None:
            continue
        counted = (r.t_done - r.t_submit) <= r.deadline_s
        missed = (r.t_done - r.t_submit) > r.deadline_s
        if counted and missed:
            bad += 1
    return bad


class Watchdog:
    """Detects replicas that hold work but make no progress.

    `check` runs once a cluster step for each healthy replica and returns
    a quarantine reason ("nan" / "stall") or None.  Progress is token
    emission: a replica with queued or in-flight requests whose
    `tokens_out` has not moved for `stall_steps` checks in a row is
    stalled; an engine that flagged non-finite logits is "nan" at once.
    """

    def __init__(self, n_replicas: int, *, stall_steps: int = STALL_STEPS,
                 nan_check: bool = True):
        self.stall_steps = stall_steps
        self.nan_check = nan_check
        self._last_tokens = [0] * n_replicas
        self._idle = [0] * n_replicas
        self.events: list[tuple[int, int, str]] = []   # (step, replica, reason)

    def reset(self, i: int) -> None:
        """Forget replica `i`'s history (after a restart rebuilt it)."""
        self._last_tokens[i] = 0
        self._idle[i] = 0

    def check(self, i: int, eng) -> str | None:
        if self.nan_check and eng.health.get("nan_detected"):
            return "nan"
        tokens = eng.stats["tokens_out"]
        has_work = bool(eng.queue) or any(s is not None for s in eng.slots)
        if not has_work or tokens > self._last_tokens[i]:
            self._last_tokens[i] = tokens
            self._idle[i] = 0
            return None
        self._idle[i] += 1
        if self._idle[i] >= self.stall_steps:
            return "stall"
        return None


def _fill_nan(tree, index: int, dim: int) -> None:
    """Every floating tensor of `tree` with more than `dim` dims gets NaN
    at `index` along `dim`, in place."""
    def fill(t):
        if isinstance(t, torch.Tensor) and t.is_floating_point() and t.dim() > dim:
            t.select(dim, index).fill_(float("nan"))
        return t
    tree_map(fill, tree)


def inject_nan(eng) -> bool:
    """Poison one live KV page (or slot) of `eng` in place: the first page
    owned by the first live slot of a paged pool (its scales in an int8
    pool, which cannot hold a NaN), else that slot's dense rectangles
    (their scales when int8) or its recurrent state.  Returns False (a
    no-op) when the engine holds no live slot."""
    live = [b for b, r in enumerate(eng.slots) if r is not None]
    if not live:
        return False
    if getattr(eng, "remote", False):
        # another rank's replica (`cluster.ReplicaView`): its own ranks
        # poison it; a live slot always owns a page, so they find one
        return True
    if eng.paged:
        pages = eng.pool.owned(live[0])
        if not pages:
            return False
        # pool leaves (L, P, ps, Hkv, hd), scales (L, P, 1, Hkv, 1): page on axis 1
        _fill_nan(eng.pool.scales if eng.pool.quant else eng.pool.segments, pages[0], 1)
        return True
    b = live[0]
    state = eng.state
    if getattr(state, "quantized", False):
        _fill_nan(state.scales, b, 1)            # (L, B, 1, Hkv, 1)
    elif "segments" in eng.cache:
        # (L, B, C, Hkv, hd): on the data row holding slot b where the
        # slots split over "data" (under SP each row poisons its block)
        at = state.local_slot(b)
        if at is not None:
            _fill_nan(eng.cache["segments"], at, 1)
    else:
        _fill_nan(eng.cache["layers"], b, 0)     # batch on axis 0
    return True


CHAOS_KINDS = ("kill", "restart", "stall", "unstall", "nan")


@dataclasses.dataclass(frozen=True, order=True)
class ChaosEvent:
    """At cluster step `step`, do `kind` to `replica`; events sort by
    (step, replica, kind)."""

    step: int
    replica: int
    kind: str

    def __post_init__(self):
        if self.kind not in CHAOS_KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; pick one of {CHAOS_KINDS}")


class ChaosSchedule:
    """A deterministic fault script replayed against a live cluster.

    `apply(cluster, step)` fires every event whose step has come due
    (keyed to the cluster's step counter, not the wall clock, so a script
    reproduces exactly whatever the host's speed)."""

    def __init__(self, events):
        self.events: list[ChaosEvent] = sorted(events)
        self._i = 0
        self.fired: list[tuple[int, ChaosEvent]] = []
        # (step, replica) of the nan events that found a live slot to poison
        self.poisoned: list[tuple[int, int]] = []

    @property
    def pending(self) -> bool:
        return self._i < len(self.events)

    def apply(self, cluster, step: int) -> list[ChaosEvent]:
        """Fire all events due at or before `step`; returns them."""
        fired: list[ChaosEvent] = []
        while self._i < len(self.events) and self.events[self._i].step <= step:
            ev = self.events[self._i]
            self._i += 1
            if ev.kind == "kill":
                cluster.kill_replica(ev.replica)
            elif ev.kind == "restart":
                cluster.restart_replica(ev.replica)
            elif ev.kind == "stall":
                cluster.stall_replica(ev.replica)
            elif ev.kind == "unstall":
                cluster.unstall_replica(ev.replica)
            elif inject_nan(cluster.replicas[ev.replica]):
                self.poisoned.append((step, ev.replica))
            self.fired.append((step, ev))
            fired.append(ev)
        return fired

    @classmethod
    def generate(cls, seed: int = CHAOS_SEED, *, n_replicas: int, horizon: int,
                 kills: int = 1, stalls: int = 1, nans: int = 1,
                 restart_after: int = 12) -> "ChaosSchedule":
        """Seeded random fault script over `horizon` cluster steps.  Each
        kill and stall is paired with its recovery `restart_after` steps
        later, each nan with a restart, and the last replica is never a
        target, so the script alone cannot take the whole fleet down.
        One rng drives every draw, in the JAX package's order."""
        rng = np.random.default_rng(seed)
        events: list[ChaosEvent] = []
        span = max(horizon - restart_after - 1, 1)
        targets = max(n_replicas - 1, 1)
        for kind, reco, n in (("kill", "restart", kills), ("stall", "unstall", stalls),
                              ("nan", "restart", nans)):
            for _ in range(n):
                step = int(rng.integers(1, span + 1))
                replica = int(rng.integers(0, targets))
                events.append(ChaosEvent(step, replica, kind))
                events.append(ChaosEvent(step + restart_after, replica, reco))
        return cls(events)
