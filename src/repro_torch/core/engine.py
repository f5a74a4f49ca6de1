"""Cross-layer evaluation engine for the Mozart codesign stack.

Three independent accelerations over the seed implementation, all
result-preserving for a fixed seed:

  * vectorization — `perfmodel.enumerate_stage_options` evaluates the
    whole (chiplet x memory x mem_units x tp x batch) grid of a fusion
    group as float64 tensors on the caller's device instead of per-option
    scalar math (the engine path keeps the results as column blocks —
    StageOption objects materialize only for a solver's winners),
    `convexhull.solve_pipeline` sweeps the iso-latency grid as a dense
    (options x latencies) tensor min instead of a Python hull walk, and a
    whole GA generation's Layer-3 solves collapse into ONE
    `convexhull.solve_pipeline_batch` call (`fusion.evaluate_genomes`;
    its `batch_solve=False` restores the per-genome loop);
  * memoization — Layer-2 GA results are cached per
    (pool fingerprint, network, objective, requirement, GA budget,
    device), so SA iterations that revisit a pool (rejected moves,
    identity mutations, the final full-budget re-eval) skip the GA
    entirely; stage options are additionally cached per *single chiplet*
    (and device) so a one-SKU neighbor move only enumerates options for
    the new SKU; and config grids, per-block dominance masks, and default
    latency grids are memoized across groups/genomes/pools;
  * parallelism — `evaluate_pool`'s per-network loop can fan out over a
    thread pool or, since the GA inner loop is GIL-bound Python, a
    spawn-safe process pool (`workers` for the width, `executor` =
    "thread" | "process" for the kind).  Process workers are spawned
    (never forked: CUDA does not survive a fork), run on the caller's
    device, are persistent and keep their own cache shard (engine memo +
    fusion option caches live for the worker's lifetime); results are
    merged back into the parent engine's memo.  A failure to spawn or to
    pickle falls back to the thread path and `stats()` counts it; a
    worker's own error (e.g. a card it cannot reach) is raised.  A
    pre-spawn warmup (`warmup`, on by default) ships the parent's per-SKU
    option columns to workers as one host float64 matrix over
    multiprocessing shared memory (pickle fallback), which each worker
    moves to its device, and merges worker-discovered columns back each
    round, so no (group, SKU) option block is enumerated twice anywhere
    in the pool — `EvaluationEngine.stats()` reports the warmup_hits /
    worker_enumerations traffic.

`set_engine_enabled(False)` restores the seed's scalar, uncached
behavior.  Every cache that holds tensors is keyed by device, so a run on
the card and a run on the CPU in one process never share a tensor.
"""
from __future__ import annotations

import atexit
import math
import multiprocessing
import pickle
import threading
from concurrent.futures import BrokenExecutor, ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import astuple
from typing import TYPE_CHECKING, Sequence

import torch

from ..device import resolve_device

if TYPE_CHECKING:   # pragma: no cover - type-only; avoids an import cycle
    from .chiplets import Chiplet
    from .fusion import FusionResult, GAConfig, Requirement
    from .operators import OperatorGraph

# The global engine switch (the seed path when False); flipped only by
# set_engine_enabled — single-writer by convention, as in the reference.
_enabled = True


def engine_enabled() -> bool:
    """Global switch consulted by perfmodel/convexhull/fusion/pool."""
    return _enabled


def set_engine_enabled(flag: bool) -> None:
    global _enabled
    _enabled = bool(flag)


class _WarmupShipment:
    """Parent-side handle for one round's shared option-cache shipment:
    the packed host column matrix (in a SharedMemory block when
    available, inline otherwise) plus the metadata that lets workers
    rebuild bit-identical StageOptionColumns without re-running the perf
    model."""

    def __init__(self, payload: tuple, shm=None):
        self.payload = payload
        self._shm = shm

    def close(self) -> None:
        if self._shm is not None:
            try:
                self._shm.close()
                self._shm.unlink()
            except (OSError, BufferError):
                pass
            self._shm = None


def _attach_shm(name: str):
    """Attach to an existing SharedMemory block; the parent owns the
    block's lifetime.  On 3.13+ `track=False` skips resource-tracker
    registration entirely.  On <=3.12 attaching registers with the
    resource tracker, but pool workers share the PARENT's tracker
    process and its cache is a set — the re-registration of an
    already-tracked name is a no-op, and the parent's single unlink
    unregisters it exactly once (a worker-side unregister here would
    race other workers and KeyError inside the tracker)."""
    from multiprocessing import shared_memory
    try:
        return shared_memory.SharedMemory(name=name, track=False)
    except TypeError:                      # track= is 3.13+
        return shared_memory.SharedMemory(name=name)


def _install_warmup(payload: tuple, device: torch.device) -> int:
    """Worker-side: unpack a warmup shipment into the fusion option
    cache on `device`.  Returns the number of (group, SKU) blocks
    installed (keys already present — e.g. on a persistent worker's later
    rounds — are skipped)."""
    import numpy as np

    from . import fusion
    kind = payload[0]
    if kind == "pickle":
        _, matrix, meta = payload
        return fusion.import_option_columns(meta, matrix, device)
    _, name, shape, dtype, meta = payload
    shm = _attach_shm(name)
    try:
        matrix = np.ndarray(shape, dtype=np.dtype(dtype), buffer=shm.buf)
        return fusion.import_option_columns(meta, matrix, device)
    finally:
        shm.close()


def _process_worker(enabled: bool, pool: tuple, graph: "OperatorGraph",
                    objective: str, req: "Requirement",
                    ga: "GAConfig", warmup: tuple | None = None,
                    device: str = "cuda") -> tuple:
    """Entry point run inside a spawned worker process.

    Evaluates one (pool, network) GA through the worker's own
    DEFAULT_ENGINE on the parent's device, so each worker accumulates an
    independent cache shard (engine memo + fusion option caches) that
    persists across tasks for the life of the worker.  `enabled` carries
    the parent's engine switch across the spawn boundary.  A worker that
    cannot reach `device` raises; the parent re-raises it.

    A warmup shipment, when given, is installed into the worker's option
    cache first (so the worker never re-enumerates options any process
    already evaluated), and the options the worker DOES enumerate during
    the task are shipped back for the parent to merge and rebroadcast.
    Returns (result, {installed, enumerated}, (meta, matrix))."""
    from . import fusion
    dev = resolve_device(device)
    set_engine_enabled(enabled)
    installed = 0
    if warmup is not None:
        try:
            installed = _install_warmup(warmup, dev)
        except (OSError, ValueError):   # the block is gone: enumerate instead
            installed = 0
    known = set(fusion._chiplet_option_cache)
    before = fusion.warmup_stats()["enumerated"]
    res = DEFAULT_ENGINE.evaluate_network(list(pool), graph, objective,
                                          req, ga, device=dev)
    enumerated = fusion.warmup_stats()["enumerated"] - before
    new_keys = [k for k in fusion._chiplet_option_cache if k not in known]
    ship = fusion.export_option_columns(new_keys)
    return res, {"installed": installed, "enumerated": enumerated}, ship


class EvaluationEngine:
    """Memoized, optionally parallel evaluator for (pool, network) pairs.

    The cache key covers everything `fusion.optimize_fusion` depends on:
    the exact pool composition (order-sensitive — the GA's roofline seed
    tie-breaks on pool order), the operator graph, the objective, the
    latency requirement, the full GA budget, and the device.

    workers  — width of the per-network fan-out (0 or 1: serial);
    executor — "thread" or "process" ("process" spawns workers);
    warmup   — ship option columns to process workers before each round.
    """

    def __init__(self, workers: int = 0, executor: str = "thread",
                 warmup: bool = True):
        self.workers = workers
        self.executor = executor
        self.warmup = warmup
        self._cache: dict[tuple, "FusionResult | None"] = {}
        self._lock = threading.Lock()
        self._procpool: ProcessPoolExecutor | None = None
        self._procpool_size = 0
        # Option-cache keys already shipped to the CURRENT worker pool
        # (workers are persistent, so each block needs shipping once;
        # reset whenever the pool is recreated).
        self._shipped_keys: set[tuple] = set()
        self.hits = 0
        self.misses = 0
        # Shared-option-cache traffic over the process pool: blocks the
        # workers received prewarmed vs. blocks they had to enumerate.
        self.warmup_hits = 0
        self.worker_enumerations = 0
        # Rounds the process executor could not spawn or pickle and ran
        # on threads instead.
        self.thread_fallbacks = 0

    def stats(self) -> dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "warmup_hits": self.warmup_hits,
                "worker_enumerations": self.worker_enumerations,
                "thread_fallbacks": self.thread_fallbacks}

    # -- cache plumbing ------------------------------------------------

    @staticmethod
    def _key(pool: Sequence["Chiplet"], graph: "OperatorGraph",
             objective: str, req: "Requirement", ga: "GAConfig",
             device: torch.device) -> tuple:
        return (tuple(pool), graph, objective, req, astuple(ga), str(device))

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self.hits = 0
            self.misses = 0
            self.warmup_hits = 0
            self.worker_enumerations = 0
            self.thread_fallbacks = 0

    # -- process-pool plumbing -----------------------------------------

    def _ensure_process_pool(self, n: int) -> ProcessPoolExecutor:
        """Persistent spawn-context pool (created once, reused across SA
        iterations so the per-worker spawn + import cost is paid once and
        worker cache shards keep accumulating)."""
        if self._procpool is None or self._procpool_size < n:
            if self._procpool is not None:
                self._procpool.shutdown(wait=False, cancel_futures=True)
            # spawn, not fork: fork is unsafe under threads and CUDA, and
            # the workers must start from a clean interpreter state.
            ctx = multiprocessing.get_context("spawn")
            self._procpool = ProcessPoolExecutor(max_workers=n,
                                                 mp_context=ctx)
            self._procpool_size = n
            self._shipped_keys = set()     # fresh workers know nothing
            atexit.register(self._shutdown_process_pool)
        return self._procpool

    def _shutdown_process_pool(self) -> None:
        if self._procpool is not None:
            # wait=True: a clean join keeps this from racing
            # concurrent.futures' own interpreter-exit hook.
            self._procpool.shutdown(wait=True, cancel_futures=True)
            self._procpool = None
            self._procpool_size = 0
            self._shipped_keys = set()

    def close(self) -> None:
        """Stop the process workers, if any were started."""
        self._shutdown_process_pool()

    def _prepare_warmup(self, pool: Sequence["Chiplet"],
                        networks: dict[str, "OperatorGraph"],
                        miss: list[str], ga: "GAConfig",
                        device: torch.device) -> "_WarmupShipment | None":
        """Parent-side pre-spawn warmup: enumerate (once, in the parent)
        the option columns for every network's deterministic generation-0
        genomes, then pack what the parent cache holds for this pool and
        device — including blocks merged back from workers in earlier
        rounds — into one host matrix.  Workers are persistent, so only
        the delta not yet shipped to the CURRENT pool goes out (across SA
        iterations that is typically just the mutated SKU's blocks);
        `_shipped_keys` resets whenever the pool is recreated.  A worker
        respawned after a crash misses earlier shipments and simply
        re-enumerates — a perf hiccup, never a correctness problem."""
        from . import fusion
        for name in miss:
            graph = networks[name]
            pop = fusion.initial_population(graph, list(pool), ga)
            fusion.prefetch_population_options(graph, pop, pool, ga,
                                               device=device)
        keys = [k for k in fusion.matching_option_keys(pool, ga, device)
                if k not in self._shipped_keys]
        if not keys:
            return None
        self._shipped_keys.update(keys)
        meta, matrix = fusion.export_option_columns(keys)
        if not meta:
            return None
        try:
            from multiprocessing import shared_memory
            shm = shared_memory.SharedMemory(create=True,
                                             size=max(matrix.nbytes, 1))
        except OSError:                    # no shm on this platform
            return _WarmupShipment(("pickle", matrix, meta))
        import numpy as np
        np.ndarray(matrix.shape, dtype=matrix.dtype, buffer=shm.buf)[:] = matrix
        return _WarmupShipment(("shm", shm.name, matrix.shape,
                                matrix.dtype.str, meta), shm)

    def _map_process(self, pool: Sequence["Chiplet"],
                     networks: dict[str, "OperatorGraph"],
                     names: list[str], objective: str,
                     reqs: dict[str, "Requirement"], ga: "GAConfig",
                     n_workers: int, warmup: bool,
                     device: torch.device) -> "list[FusionResult | None] | None":
        """Fan cache misses out over the process pool; None = could not
        spawn or pickle (caller falls back to the thread path).  An error
        raised inside a worker is re-raised here."""
        from . import fusion
        from .fusion import Requirement
        keys = {name: self._key(pool, networks[name], objective,
                                reqs.get(name, Requirement()), ga, device)
                for name in names}
        results: dict[str, "FusionResult | None"] = {}
        miss: list[str] = []
        with self._lock:
            for name in names:
                if keys[name] in self._cache:
                    self.hits += 1
                    results[name] = self._cache[keys[name]]
                else:
                    miss.append(name)
        if miss:
            # Pool first: creating/resizing it resets the shipped-key
            # tracking the delta shipment below is computed against.
            try:
                ex = self._ensure_process_pool(n_workers)
            except OSError:
                self._shutdown_process_pool()
                return None
            warm: "_WarmupShipment | None" = None
            if warmup:
                warm = self._prepare_warmup(pool, networks, miss, ga, device)
            try:
                payload = warm.payload if warm is not None else None
                futs = {name: ex.submit(
                    _process_worker, engine_enabled(), tuple(pool),
                    networks[name], objective,
                    reqs.get(name, Requirement()), ga, payload, str(device))
                    for name in miss}
                got = {}
                for name, f in futs.items():
                    res, wstats, ship = f.result()
                    got[name] = res
                    with self._lock:
                        self.warmup_hits += wstats["installed"]
                        self.worker_enumerations += wstats["enumerated"]
                    # Merge worker-discovered blocks into the parent
                    # cache so the next round's shipment covers them.
                    fusion.import_option_columns(*ship, device)
            except (BrokenExecutor, pickle.PicklingError, OSError):
                self._shutdown_process_pool()   # spawn/pickle failure: threads
                return None
            finally:
                if warm is not None:
                    warm.close()
            with self._lock:
                for name in miss:
                    key = keys[name]
                    if key in self._cache:   # racing caller filled it
                        self.hits += 1
                        results[name] = self._cache[key]
                    else:
                        self.misses += 1
                        self._cache[key] = got[name]
                        results[name] = got[name]
        return [results[n] for n in names]

    # -- evaluation ----------------------------------------------------

    def evaluate_network(self, pool: Sequence["Chiplet"],
                         graph: "OperatorGraph", objective: str,
                         req: "Requirement", ga: "GAConfig",
                         device: str | torch.device | None = None
                         ) -> "FusionResult | None":
        from .fusion import optimize_fusion
        dev = resolve_device(device)
        key = self._key(pool, graph, objective, req, ga, dev)
        with self._lock:
            if key in self._cache:
                self.hits += 1
                return self._cache[key]
        res = optimize_fusion(graph, pool, objective=objective, req=req,
                              cfg=ga, device=dev)
        with self._lock:
            # A racing thread may have filled the slot; keep the first
            # result so repeated queries stay consistent.
            if key in self._cache:
                self.hits += 1
                return self._cache[key]
            self.misses += 1
            self._cache[key] = res
        return res

    def evaluate_pool(self, pool: Sequence["Chiplet"],
                      networks: dict[str, "OperatorGraph"],
                      objective: str,
                      reqs: dict[str, "Requirement"] | None,
                      ga: "GAConfig",
                      workers: int | None = None,
                      executor: str | None = None,
                      warmup: bool | None = None,
                      device: str | torch.device | None = None
                      ) -> tuple[float, dict[str, "FusionResult"]]:
        """(geomean objective value, per-network best design)."""
        from .fusion import Requirement
        dev = resolve_device(device)
        reqs = reqs or {}
        names = list(networks)
        n_workers = self.workers if workers is None else workers
        kind = self.executor if executor is None else executor
        warm = self.warmup if warmup is None else warmup

        def one(name: str) -> "FusionResult | None":
            return self.evaluate_network(pool, networks[name], objective,
                                         reqs.get(name, Requirement()), ga,
                                         device=dev)

        results: "list[FusionResult | None] | None" = None
        if n_workers > 1 and len(names) > 1:
            if kind == "process":
                results = self._map_process(pool, networks, names,
                                            objective, reqs, ga, n_workers,
                                            warm, dev)
                if results is None:
                    with self._lock:
                        self.thread_fallbacks += 1
            if results is None:
                with ThreadPoolExecutor(max_workers=n_workers) as ex:
                    results = list(ex.map(one, names))
        else:
            results = [one(n) for n in names]

        per: dict[str, "FusionResult"] = {}
        logsum = 0.0
        for name, res in zip(names, results):
            if res is None:
                return math.inf, {}
            per[name] = res
            logsum += math.log(max(res.value, 1e-30))
        return math.exp(logsum / max(len(names), 1)), per


DEFAULT_ENGINE = EvaluationEngine()


def clear_all_caches() -> None:
    """Reset every cross-call cache in the codesign stack (engine memo,
    fusion's stage-option caches + latency-grid memo, perfmodel's
    config-grid/chip-row LRUs), on every device."""
    from . import fusion, perfmodel
    DEFAULT_ENGINE.clear()
    fusion.clear_option_caches()
    perfmodel.clear_perfmodel_caches()
