"""Multi-replica serving cluster: router, load generator, metrics (the
port of `repro.serving.cluster`).

`ServingCluster` scales one `ServingEngine` out to N replicas behind a
`Router`:

* ``round_robin``     — cycle over replica ids, skipping unhealthy ones;
* ``least_loaded``    — most free KV pages (free slots for dense and
  recurrent engines);
* ``shortest_queue``  — join-shortest-queue over queued + in-flight
  requests.

Ties break on the lowest replica id.  The replicas share one card and one
set of weight tensors (`ServingEngine` moves the params to its device,
which is a no-op for tensors already there); each owns its KV pool or
state.  A mixed-family fleet passes `replica_models`, one (config,
params) pair a replica, and a request tagged with `Request.model` routes
only to replicas serving that model name.

Failures: `kill_replica(i)` requeues everything the replica held onto the
survivors (in-flight slots resume by re-prefilling prompt + emitted
tokens), at the front of their queues, so greedy decoding recovers
token-exactly.  Each failover spends one unit of a request's retry
budget; past it the request is "poison".  Killing the last healthy
replica parks its work on the cluster (`n_unrouted`) until
`restart_replica(i)` rebuilds the engine from the stored arguments and
drains the parked queue.  A `resilience.Watchdog` runs every step and
quarantines a replica that holds work but emits no token for its
`stall_steps`, or whose engine flagged non-finite logits.  Bounded
queues (`queue_bound`) give backpressure: a fleet whose healthy queues
are all full sheds a submission.

`LoadGenerator` is a seeded open-loop Poisson source over the Zipf
prompt mix of `serving.workload`.  `ClusterMetrics` samples per-replica
queue depth, live slots and free pages every step and reduces request
marks into aggregate and per-replica TTFT/TPOT percentiles and counters.

Without a mesh the replicas share one device and step round-robin in
one host loop.  `ServingCluster(mesh=)` serves each replica on its own
submesh, as the JAX cluster does: `sharding.replica_meshes` splits the
mesh over "data", and each rank builds the real `ServingEngine` only
for its own replica (on that replica's mesh, tensor-parallel over its
"model" ranks).  Every rank runs the same router, admission, watchdog
and chaos schedule over every replica, so their decisions must agree:
each other replica is a `ReplicaView`, a host-side mirror the rank never
computes, and after each cluster step one fixed-size exchange over
"data" (an all_gather) brings every replica's events of that step to
every rank: the tokens each request emitted, finishes, queue order,
slot occupants, queue depth, live slots, free pages and the NaN flag
(a stall is read off those, as without a mesh).  A replica's model
peers hold the same scheduler state as its root (the engine broadcasts
rank 0's tokens), so each contributes the same events.

Clocks.  Every read of a clock must agree on every rank: on a mesh the
cluster takes time from its global root's clock, broadcast (at each
exchange and at each turn of `drive`).  Open-loop arrivals, the
submission marks and the deadline verdicts read that agreed time; an
engine's marks made during a step (TTFT, finishes) are stamped with the
agreed time at the step's exchange on every rank, and its pace for
deadline shedding is fed from the agreed step durations
(`ServingEngine.observe_step`).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding
from repro_torch.parallel.mesh import Mesh

from . import paged as paged_kv
from . import resilience, workload
from .engine import Request, ServingEngine

ROUTER_POLICIES = ("round_robin", "least_loaded", "shortest_queue")
ROUTER = "round_robin"    # the JAX knob registry's defaults
RETRY_BUDGET = 3


def _free_capacity(eng: ServingEngine) -> int:
    """Admission headroom: free KV pages of a paged engine, free slots
    otherwise (only the ordering matters)."""
    if eng.paged:
        return eng.pool.free_pages
    return sum(1 for s in eng.slots if s is None)


def _queue_load(eng: ServingEngine) -> int:
    return len(eng.queue) + sum(1 for s in eng.slots if s is not None)


def _has_work(eng: ServingEngine) -> bool:
    return bool(eng.queue) or any(s is not None for s in eng.slots)


class Router:
    """Request-routing policy over the healthy replicas; ties break on the
    lowest replica id, so routing is deterministic for a fixed order of
    submissions."""

    def __init__(self, policy: str = ROUTER):
        if policy not in ROUTER_POLICIES:
            raise ValueError(
                f"unknown router policy {policy!r}; pick one of {ROUTER_POLICIES}")
        self.policy = policy
        self._rr = 0

    def pick(self, replicas: list[ServingEngine], healthy: list[int]) -> int:
        if not healthy:
            raise RuntimeError("no healthy replicas to route to")
        if self.policy == "round_robin":
            # cycle over replica ids: a dead replica's turn passes on
            for _ in range(len(replicas)):
                i = self._rr % len(replicas)
                self._rr += 1
                if i in healthy:
                    return i
            return healthy[0]
        if self.policy == "least_loaded":
            return max(healthy, key=lambda i: (_free_capacity(replicas[i]), -i))
        return min(healthy, key=lambda i: (_queue_load(replicas[i]), i))


@dataclasses.dataclass
class LoadGenerator:
    """Seeded open-loop Poisson source over the Zipf prompt mix; `rate`
    in requests a second (`rate <= 0`: every request due at t = 0)."""

    n_requests: int
    rate: float
    vocab: int
    seed: int = 0
    max_new_tokens: int = 16
    bands: tuple[tuple[int, int], ...] = workload.DEFAULT_BANDS
    # per-request SLO mix (workload.DEFAULT_DEADLINE_BANDS); None = no deadlines
    deadline_bands: tuple[tuple[float, float] | None, ...] | None = None

    def schedule(self) -> list[tuple[float, Request]]:
        """[(arrival offset in seconds, request)], arrival-sorted; one rng
        drives both draws, so a seed pins the trace."""
        rng = np.random.default_rng(self.seed)
        reqs = workload.zipf_mix_requests(
            rng, self.n_requests, self.vocab, bands=self.bands,
            max_new_tokens=self.max_new_tokens, deadline_bands=self.deadline_bands)
        times = workload.poisson_arrivals(rng, self.n_requests, self.rate)
        return list(zip(times.tolist(), reqs))


class ClusterMetrics:
    """Per-step occupancy series + request-mark reductions."""

    def __init__(self, n_replicas: int):
        self.n_replicas = n_replicas
        self.series: dict[str, list[tuple[int, ...]]] = {
            "queue_depth": [], "live_slots": [], "free_pages": []}

    def tick(self, replicas: list[ServingEngine]) -> None:
        self.series["queue_depth"].append(tuple(len(r.queue) for r in replicas))
        self.series["live_slots"].append(
            tuple(sum(1 for s in r.slots if s is not None) for r in replicas))
        self.series["free_pages"].append(
            tuple(r.pool.free_pages if r.paged else 0 for r in replicas))

    @staticmethod
    def _pct_ms(samples: list[float], q: float) -> float:
        return float(np.percentile(np.asarray(samples), q) * 1e3) if samples else 0.0

    @classmethod
    def _latency(cls, reqs: list[Request]) -> dict[str, float]:
        ttft = [r.t_first - r.t_submit for r in reqs if r.t_first is not None]
        tpot = [(r.t_done - r.t_first) / (len(r.out_tokens) - 1) for r in reqs
                if r.t_done is not None and r.t_first is not None
                and len(r.out_tokens) > 1]
        with_dl = [r for r in reqs if r.deadline_s is not None and r.t_done is not None
                   and r.finish_reason not in ("shed", "poison", "rejected")]
        return {
            "ttft_p50_ms": cls._pct_ms(ttft, 50),
            "ttft_p99_ms": cls._pct_ms(ttft, 99),
            "tpot_p50_ms": cls._pct_ms(tpot, 50),
            "tpot_p99_ms": cls._pct_ms(tpot, 99),
            "n_finished": sum(1 for r in reqs if r.t_done is not None),
            "deadline_met": sum(1 for r in with_dl if r.t_done - r.t_submit <= r.deadline_s),
            "deadline_missed": sum(1 for r in with_dl if r.t_done - r.t_submit > r.deadline_s),
        }

    def summary(self, cluster: "ServingCluster") -> dict:
        """Aggregate and per-replica latency percentiles, engine counters
        (those of engines a restart retired folded back in) and
        occupancy peaks."""
        per_replica = []
        for i, eng in enumerate(cluster.replicas):
            mine = [r for r in cluster.requests if cluster.assignment.get(r.rid) == i]
            row = dict(self._latency(mine))
            row.update(replica=i, healthy=i in cluster.healthy,
                       tokens_out=eng.stats["tokens_out"],
                       decode_steps=eng.stats["decode_steps"],
                       prefills=eng.stats["prefills"],
                       preemptions=eng.stats["preemptions"],
                       rejected=eng.stats["rejected"])
            per_replica.append(row)
        retired = cluster._retired
        agg = dict(self._latency(cluster.requests))
        agg.update(
            n_replicas=len(cluster.replicas),
            router=cluster.router.policy,
            tokens_out=sum(r["tokens_out"] for r in per_replica) + retired["tokens_out"],
            preemptions=sum(r["preemptions"] for r in per_replica) + retired["preemptions"],
            rejected=sum(r["rejected"] for r in per_replica) + retired["rejected"],
            requeued=cluster.stats["requeued"],
            replica_failures=cluster.stats["replica_failures"],
            n_unrouted=len(cluster.parked),
            shed=cluster.stats["shed"] + retired["shed"]
            + sum(e.stats["shed"] for e in cluster.replicas),
            poisoned=cluster.stats["poisoned"],
            quarantined=cluster.stats["quarantined"],
            restarts=cluster.stats["restarts"],
            goodput_tokens=resilience.goodput_tokens(cluster.requests),
            peak_queue_depth=max((sum(t) for t in self.series["queue_depth"]), default=0),
            min_free_pages=min((min(t) for t in self.series["free_pages"]), default=0),
        )
        return {"aggregate": agg, "per_replica": per_replica}


# engine counters a replica reports in each exchange, in order
STAT_KEYS = ("tokens_out", "decode_steps", "prefills", "preemptions", "rejected", "shed",
             "nan_steps")
FINISH_CODES = (None, "eos", "max_new_tokens", "length", "capacity", "shed", "rejected",
                "poison")
TOKENS_A_STEP = 2          # at most: a prefill's first token and a decode's
# a request's row: held, tokens emitted, the tokens, finish code, t_first
# set, t_done set, admission order
_REQ_FIELDS = 6 + TOKENS_A_STEP
_HEAD = 4 + len(STAT_KEYS)      # active, counters, NaN flag, free pages, queue depth


class _PoolView:
    free_pages = 0


class ReplicaView:
    """Another replica as a rank of a cluster on a mesh sees it: the
    scheduler state the router, watchdog, chaos schedule and metrics
    read (slots, queue, counters, health, free pages), set from the
    replica's events at each exchange and mutated by the cluster's own
    routing as a real engine's would be.  No model runs behind it."""

    remote = True

    def __init__(self, mcfg: ModelConfig, *, max_batch: int, paged: bool,
                 queue_bound: int):
        self.mcfg = mcfg
        self.paged = paged
        self.pool = _PoolView() if paged else None
        self.slots: list[Request | None] = [None] * max_batch
        self.queue: list[Request] = []
        self.queue_bound = queue_bound
        self.stats = {k: 0 for k in STAT_KEYS}
        self.health = {"nan_detected": False}
        self.state = self

    @property
    def queue_full(self) -> bool:
        return self.queue_bound > 0 and len(self.queue) >= self.queue_bound

    def submit(self, req: Request) -> bool:
        self.queue.append(req)
        return True

    def release(self, b: int) -> None:
        pass


class ServingCluster:
    """N `ServingEngine` replicas behind one router, on one device or on
    per-replica meshes (see the module docstring).

    `engine_kwargs` go to every replica's engine (and to the engines
    `restart_replica` rebuilds); `replica_models` gives each replica its
    own (config, params) pair.  `mesh` (a rank's `parallel.mesh.Mesh`,
    every rank of it constructing the cluster alike): the replicas split
    it over "data" and this rank serves its own; `params` (and each
    `replica_models` entry's) is then the whole tree, which the rank cuts
    to its replica mesh's blocks (`sharding.shard_params`), or a function
    of the replica mesh giving those blocks (e.g. `lambda m:
    api.init_params(cfg, seed, mesh=m)`)."""

    def __init__(self, mcfg: ModelConfig, params, *, n_replicas: int | None = None,
                 router: Router | str = ROUTER, retry_budget: int = RETRY_BUDGET,
                 watchdog: resilience.Watchdog | None = None,
                 replica_models: list[tuple[ModelConfig, object]] | None = None,
                 mesh=None, **engine_kwargs):
        if replica_models is not None:
            n = n_replicas or len(replica_models)
            if len(replica_models) != n:
                raise ValueError(f"replica_models has {len(replica_models)} entries "
                                 f"for {n} replicas")
        else:
            n = n_replicas or 1
        if n < 1:
            raise ValueError(f"need at least one replica, got {n}")
        self._replica_models = list(replica_models) if replica_models is not None \
            else [(mcfg, params)] * n
        self._engine_kwargs = dict(engine_kwargs)
        self.mesh = mesh
        self._now = 0.0                 # the agreed clock (a mesh's)
        self._pos: dict[int, int] = {}  # id(request) -> index in self.requests
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise ValueError("ServingCluster(mesh=) needs a rank's Mesh "
                                 "(launch.mesh.make_host_mesh), not a shape")
            self._meshes = sharding.replica_meshes(mesh, n)
            self._own = next(i for i, m in enumerate(self._meshes) if isinstance(m, Mesh))
            rcfg, rparams = self._replica_models[self._own]
            own = self._meshes[self._own]
            self._own_params = rparams(own) if callable(rparams) else \
                sharding.shard_params(rparams, own, rcfg)
        self.replicas = [self._new_engine(i) for i in range(n)]
        self.router = router if isinstance(router, Router) else Router(router)
        self.healthy: list[int] = list(range(n))
        self.requests: list[Request] = []
        self.assignment: dict[int, int] = {}    # rid -> serving replica
        self.metrics = ClusterMetrics(n)
        self.retry_budget = retry_budget
        self.watchdog = watchdog or resilience.Watchdog(n)
        # requests held while no eligible replica is healthy
        self.parked: list[Request] = []
        # chaos-wedged replicas: healthy, but step() skips them
        self.stalled: set[int] = set()
        self.stats = {"requeued": 0, "replica_failures": 0, "steps": 0, "shed": 0,
                      "poisoned": 0, "quarantined": 0, "restarts": 0,
                      "unrouted_total": 0}
        # counters of engines retired by restart_replica
        # counters of the engines a restart retired, folded back into the
        # summary (decode_steps / nan_steps: the fleet's decode-step total)
        self._retired = {"tokens_out": 0, "preemptions": 0, "rejected": 0, "shed": 0,
                         "decode_steps": 0, "nan_steps": 0}
        if mesh is not None:
            self._sync()

    # -- replicas on a mesh ----------------------------------------------------

    def _time(self) -> float:
        """The cluster's clock: the agreed one on a mesh, else the host's."""
        return self._now if self.mesh is not None else time.monotonic()

    def _agree_time(self) -> float:
        """The global root's clock, broadcast to every rank of the mesh."""
        t = torch.tensor([time.monotonic()], dtype=torch.float64, device=self.mesh.device)
        self._now = float(coll.broadcast(t, self.mesh)[0])
        return self._now

    def _new_engine(self, i: int):
        """Replica i's engine: the real one on its own ranks (its blocks,
        its mesh, the agreed clock), a `ReplicaView` elsewhere."""
        rcfg, rparams = self._replica_models[i]
        if self.mesh is None:
            return ServingEngine(rcfg, rparams, **self._engine_kwargs)
        if i == self._own:
            eng = ServingEngine(rcfg, self._own_params, mesh=self._meshes[i],
                                **self._engine_kwargs)
            eng.clock = self._time
            eng.self_paced = False
            return eng
        kw = self._engine_kwargs
        return ReplicaView(rcfg, max_batch=kw.get("max_batch", 4),
                           paged=kw.get("paged", True) and paged_kv.paged_supported(rcfg),
                           queue_bound=kw.get("queue_bound", 0))

    def _sync(self) -> None:
        """An exchange outside a step: the views take their replicas'
        state as it stands (a new engine's free pages, which routing reads
        at once)."""
        self._exchange({}, 0)

    def _events(self, before: dict, active: int) -> torch.Tensor:
        """This rank's replica's events since `before` (request index ->
        (tokens, done, t_first unset, t_done unset) at the step's start),
        as one int64 vector: a header (active slots, the counters, NaN
        flag, free pages, queue depth), the slot occupants and the queue
        (request indices, -1 past the end), then a row for every request
        (held, tokens emitted this step, finish code, marks set, admission
        order)."""
        eng = self.replicas[self._own]
        n = len(self.requests)
        head = [active, *(eng.stats[k] for k in STAT_KEYS),
                int(eng.health["nan_detected"]),
                eng.pool.free_pages if eng.paged else 0, len(eng.queue)]
        slots = [-1 if r is None else self._pos[id(r)] for r in eng.slots]
        queue = [self._pos[id(r)] for r in eng.queue] + [-1] * (n - len(eng.queue))
        rows = np.zeros((n, _REQ_FIELDS), np.int64)
        for k, (n0, done0, first0, end0) in before.items():
            r = self.requests[k]
            new = r.out_tokens[n0:]
            if len(new) > TOKENS_A_STEP:
                raise RuntimeError(f"request {r.rid} emitted {len(new)} tokens in one "
                                   f"step; the exchange carries {TOKENS_A_STEP}")
            rows[k] = [1, len(new), *new, *[0] * (TOKENS_A_STEP - len(new)),
                       FINISH_CODES.index(r.finish_reason) if r.done and not done0 else 0,
                       int(first0 and r.t_first is not None),
                       int(end0 and r.t_done is not None), r.admit_seq]
        vec = np.concatenate([np.asarray(head + slots + queue, np.int64), rows.reshape(-1)])
        return torch.as_tensor(vec, device=self.mesh.device)

    def _exchange(self, before: dict, active: int) -> int:
        """Every replica's events of this step on every rank (one
        all_gather over "data") and the agreed end-of-step time (a
        broadcast); applies them: the other replicas' tokens, finishes
        and views, every replica's marks.  Returns the active slots over
        all replicas."""
        vec = self._events(before, active)
        rows = coll.all_gather(vec, self.mesh, "data", dim=0).reshape(
            self.mesh.shape["data"], -1).cpu().numpy()
        t_end = self._agree_time()
        per = self.mesh.shape["data"] // len(self.replicas)
        n, ns = len(self.requests), len(STAT_KEYS)
        total = 0
        for i, eng in enumerate(self.replicas):
            row = rows[i * per]                 # the replica's first data row
            total += int(row[0])
            mb = len(eng.slots)
            req_rows = row[_HEAD + mb + n:].reshape(n, _REQ_FIELDS)
            remote = i != self._own
            for k in np.flatnonzero(req_rows[:, 0]):
                r, f = self.requests[k], req_rows[k]
                if remote:
                    r.out_tokens.extend(int(t) for t in f[2:2 + f[1]])
                    code = int(f[2 + TOKENS_A_STEP])
                    if code:
                        r.done, r.finish_reason = True, FINISH_CODES[code]
                    r.admit_seq = int(f[-1])
                if f[3 + TOKENS_A_STEP]:
                    r.t_first = t_end
                if f[4 + TOKENS_A_STEP]:
                    r.t_done = t_end
            if remote:
                eng.stats.update(zip(STAT_KEYS, (int(x) for x in row[1:1 + ns])))
                eng.health["nan_detected"] = bool(row[1 + ns])
                if eng.paged:
                    eng.pool.free_pages = int(row[2 + ns])
                eng.slots = [None if j < 0 else self.requests[j]
                             for j in row[_HEAD:_HEAD + mb]]
                eng.queue = [self.requests[j]
                             for j in row[_HEAD + mb:_HEAD + mb + int(row[3 + ns])]]
        return total

    # -- request lifecycle ---------------------------------------------------

    def _eligible(self, req: Request, candidates: list[int]) -> list[int]:
        """Replicas allowed to serve `req`: all candidates for an untagged
        request, else those serving its model name."""
        if req.model is None:
            return candidates
        return [i for i in candidates if self.replicas[i].mcfg.name == req.model]

    def _park(self, req: Request) -> None:
        self.parked.append(req)
        self.stats["unrouted_total"] += 1

    def _front_queue(self, req: Request, eligible: list[int]) -> None:
        """Route a failed-over or parked request to the front of a queue."""
        j = self.router.pick(self.replicas, eligible)
        self.assignment[req.rid] = j
        self.replicas[j].queue.insert(0, req)
        self.stats["requeued"] += 1

    def submit(self, req: Request) -> int:
        """Route one request; returns its replica, or -1 when it is parked
        (no eligible healthy replica) or shed (every such queue full)."""
        if req.t_submit is None:
            req.t_submit = self._time()
        self._pos[id(req)] = len(self.requests)
        self.requests.append(req)
        eligible = self._eligible(req, self.healthy)
        if not eligible:
            self._park(req)
            return -1
        routable = [i for i in eligible if not self.replicas[i].queue_full]
        if not routable:
            req.done = True
            req.finish_reason = "shed"
            req.t_done = self._time()
            self.stats["shed"] += 1
            return -1
        i = self.router.pick(self.replicas, routable)
        self.assignment[req.rid] = i
        self.replicas[i].submit(req)
        return i

    def _requeue(self, req: Request) -> None:
        """Failover: spend one retry, then park or front-queue on a
        survivor; past the retry budget the request is poison."""
        req.requeues += 1
        if self.retry_budget >= 0 and req.requeues > self.retry_budget:
            req.done = True
            req.finish_reason = "poison"
            req.t_done = self._time()
            self.stats["poisoned"] += 1
            return
        eligible = self._eligible(req, self.healthy)
        if not eligible:
            self._park(req)
            return
        self._front_queue(req, eligible)

    def kill_replica(self, i: int) -> int:
        """Fail replica `i`: requeue everything it held onto the survivors,
        or park it when none is left.  Returns the requests moved."""
        if i not in self.healthy:
            return 0
        self.healthy.remove(i)
        eng = self.replicas[i]
        stranded: list[Request] = []
        for b, req in enumerate(eng.slots):
            if req is None:
                continue
            eng.slots[b] = None
            eng.state.release(b)
            stranded.append(req)
        stranded.extend(eng.queue)
        eng.queue.clear()
        for req in stranded:
            if not req.done:
                self._requeue(req)
        self.stats["replica_failures"] += 1
        return len(stranded)

    def restart_replica(self, i: int) -> int:
        """Rebuild replica `i`'s engine from the stored arguments, rejoin
        it to the healthy set and drain the parked requests through the
        router.  The old engine's pool is dropped before the new one
        allocates.  Returns the parked requests drained."""
        if i in self.healthy:
            return 0
        old = self.replicas[i]
        for key in self._retired:
            self._retired[key] += old.stats[key]
        self.replicas[i] = None
        del old
        self.replicas[i] = self._new_engine(i)
        if self.mesh is not None:
            self._sync()
        self.healthy.append(i)
        self.healthy.sort()
        self.stalled.discard(i)
        self.watchdog.reset(i)
        self.stats["restarts"] += 1
        parked, self.parked = self.parked, []
        drained = 0
        # front-of-queue priority, original order kept
        for req in reversed(parked):
            if req.done:
                continue
            eligible = self._eligible(req, self.healthy)
            if not eligible:
                self.parked.insert(0, req)   # its model's replica is still down
                continue
            self._front_queue(req, eligible)
            drained += 1
        return drained

    # -- fault injection / watchdog ------------------------------------------

    def stall_replica(self, i: int) -> None:
        """Wedge replica `i`: it keeps its work, step() skips it."""
        self.stalled.add(i)

    def unstall_replica(self, i: int) -> None:
        self.stalled.discard(i)

    def quarantine(self, i: int, reason: str) -> int:
        """The watchdog's action: `kill_replica` plus the bookkeeping."""
        if i not in self.healthy:
            return 0
        moved = self.kill_replica(i)
        self.stats["quarantined"] += 1
        self.watchdog.events.append((self.stats["steps"], i, reason))
        return moved

    # -- drive loops ---------------------------------------------------------

    @property
    def pending_work(self) -> bool:
        return any(_has_work(self.replicas[i]) for i in self.healthy)

    def step(self) -> int:
        """Every healthy, unstalled replica with work takes one engine
        step (on a mesh: this rank's own replica, the others on their
        ranks, then the exchange), then the watchdog quarantines sick
        replicas.  Returns the active slots stepped."""
        active, stepped = 0, False
        if self.mesh is not None:
            t_start = self._now
            own = self.replicas[self._own]
            before = {self._pos[id(r)]: (len(r.out_tokens), r.done, r.t_first is None,
                                         r.t_done is None)
                      for r in [r for r in own.slots if r is not None] + own.queue}
        for i in self.healthy:
            if i not in self.stalled and _has_work(self.replicas[i]) \
                    and (self.mesh is None or i == self._own):
                active += self.replicas[i].step()
                stepped = True
        if self.mesh is not None:
            active = self._exchange(before, active)
            if stepped:     # the own engine's pace, from the agreed clock
                own.observe_step(self._now - t_start)
        for i in list(self.healthy):
            reason = self.watchdog.check(i, self.replicas[i])
            if reason is not None:
                self.quarantine(i, reason)
        self.metrics.tick(self.replicas)
        self.stats["steps"] += 1
        return active

    def run(self, max_steps: int = 100_000, chaos=None) -> None:
        """Closed-loop drive to completion; `chaos` (a
        `resilience.ChaosSchedule`) fires its events before each step.
        A total outage returns with the unfinished requests parked."""
        steps = 0
        while steps < max_steps:
            if chaos is not None:
                chaos.apply(self, self.stats["steps"])
            if not (self.pending_work or (chaos is not None and chaos.pending)):
                break
            self.step()
            steps += 1

    def drive(self, schedule: list[tuple[float, Request]], max_steps: int = 1_000_000,
              chaos=None) -> dict:
        """Open-loop replay: submit each request at (or after) its arrival
        offset while stepping the replicas; idle gaps sleep until the
        next arrival (on a mesh every turn reads the agreed clock).
        Returns `metrics.summary`."""
        clock = time.monotonic if self.mesh is None else self._agree_time
        t0 = clock()
        idx, steps = 0, 0
        n = len(schedule)
        while steps < max_steps:
            if chaos is not None:
                chaos.apply(self, self.stats["steps"])
            now = clock() - t0
            while idx < n and schedule[idx][0] <= now:
                self.submit(schedule[idx][1])
                idx += 1
            if not (idx < n or self.pending_work or (chaos is not None and chaos.pending)):
                break
            if self.pending_work:
                self.step()
                steps += 1
            elif idx < n:
                time.sleep(min(max(schedule[idx][0] - now, 0.0), 0.05))
            else:
                # only chaos events remain (e.g. a restart that drains
                # the parked queue): let them fire
                self.step()
                steps += 1
        return self.metrics.summary(self)
