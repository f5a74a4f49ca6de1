"""Layer 1: simulated annealing over chiplet pool composition (paper §4.1).

A pool is a set of chiplet SKUs available to every BASIC.  Candidate pools
are generated by the paper's moves — dataflow transitions, PE-array
resizing, buffer reconfiguration (we add bonding flips) — and scored by
the geomean, across target networks, of the best achievable objective for
accelerators composed from the pool (Layers 2+3), whose numerics run on
the caller's device (the card unless the caller names another).
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Sequence

import torch

from ..device import resolve_device
from .chiplets import (BONDINGS, DATAFLOWS, GLB_SCALES, PE_SCALES, Chiplet,
                       default_pool, full_design_space)
from .engine import DEFAULT_ENGINE, EvaluationEngine, engine_enabled
from .fusion import GAConfig, FusionResult, Requirement, optimize_fusion
from .operators import OperatorGraph


@dataclasses.dataclass
class SAConfig:
    # The paper's Table 4 uses 5 iterations/level — a toy budget.  The
    # cached/vectorized engine made iterations cheap, and the fixed-seed
    # sweep in benchmarks/bench_budget_scaling.py shows the score still
    # improving past 5 (0.02006 -> 0.01959 at 10) and saturating well
    # before 16, so the default budget is 16 (~1.8 s on the dev
    # container vs 0.5 s for the paper budget).
    iterations: int = 16
    init_temp: float = 1.0
    cooling: float = 0.95
    seed: int = 0
    # Inner-loop (Layer 2) budget while annealing; the winning pool gets a
    # full-budget re-evaluation.
    inner_ga: GAConfig = dataclasses.field(
        default_factory=lambda: GAConfig(population=6, generations=2))
    # Worker-pool width for the per-network evaluation loop; None
    # defers to the engine's `workers` (default 0: serial).
    workers: int | None = None
    # "thread" | "process" | None (None = the engine's `executor`,
    # default "thread").  The process executor sidesteps the GIL-bound
    # GA inner loop; spawn-safe (workers run on the caller's device),
    # falls back to threads if spawning fails.
    executor: str | None = None
    # Pre-spawn shared option-cache warmup for the process executor
    # (None = the engine's `warmup`, on by default): the parent
    # enumerates each network's generation-0 option columns once and
    # ships them to workers over shared memory, and workers ship newly
    # enumerated columns back — so no (group, SKU) option block is ever
    # evaluated twice across the pool.
    warmup: bool | None = None

    def to_dict(self) -> dict:
        return {"iterations": self.iterations,
                "init_temp": self.init_temp, "cooling": self.cooling,
                "seed": self.seed, "inner_ga": self.inner_ga.to_dict(),
                "workers": self.workers, "executor": self.executor,
                "warmup": self.warmup}

    @staticmethod
    def from_dict(d: dict) -> "SAConfig":
        d = dict(d)
        d["inner_ga"] = GAConfig.from_dict(d["inner_ga"])
        return SAConfig(**d)


@dataclasses.dataclass
class PoolResult:
    pool: list[Chiplet]
    score: float                              # geomean normalized objective
    per_network: dict[str, FusionResult]

    def to_dict(self) -> dict:
        return {"pool": [c.to_dict() for c in self.pool],
                "score": self.score,
                "per_network": {n: r.to_dict()
                                for n, r in self.per_network.items()}}

    @staticmethod
    def from_dict(d: dict) -> "PoolResult":
        return PoolResult(
            pool=[Chiplet.from_dict(c) for c in d["pool"]],
            score=d["score"],
            per_network={n: FusionResult.from_dict(r)
                         for n, r in d["per_network"].items()})


def _mutate_chiplet(c: Chiplet, rng: random.Random) -> Chiplet:
    move = rng.randrange(4)
    if move == 0:   # dataflow transition
        return dataclasses.replace(
            c, dataflow=rng.choice([d for d in DATAFLOWS if d != c.dataflow]))
    if move == 1:   # PE array resize
        i = PE_SCALES.index(c.pe_scale)
        j = max(0, min(len(PE_SCALES) - 1, i + rng.choice((-1, 1))))
        return dataclasses.replace(c, pe_scale=PE_SCALES[j])
    if move == 2:   # buffer reconfiguration
        i = GLB_SCALES.index(c.glb_scale)
        j = max(0, min(len(GLB_SCALES) - 1, i + rng.choice((-1, 1))))
        return dataclasses.replace(c, glb_scale=GLB_SCALES[j])
    return dataclasses.replace(
        c, bonding=rng.choice([b for b in BONDINGS if b != c.bonding]))


def _neighbor(pool: list[Chiplet], rng: random.Random,
              max_tries: int = 64) -> list[Chiplet]:
    """One SA move: mutate a random SKU, keeping the mutated slot
    distinct from every other pool member.  Retries until distinct (a
    single retry can re-collide and silently shrink the effective pool);
    judged against the *other* slots only, so a caller-supplied pool
    that already holds duplicates elsewhere still anneals."""
    out = list(pool)
    idx = rng.randrange(len(out))
    rest = set(out[:idx]) | set(out[idx + 1:])
    for _ in range(max_tries):
        out[idx] = _mutate_chiplet(out[idx], rng)
        if out[idx] not in rest:
            return out
    raise RuntimeError(
        f"could not find a duplicate-free neighbor of {pool} "
        f"after {max_tries} mutations")


def evaluate_pool(pool: Sequence[Chiplet],
                  networks: dict[str, OperatorGraph],
                  objective: str,
                  reqs: dict[str, Requirement] | None = None,
                  ga: GAConfig | None = None,
                  engine: EvaluationEngine | None = None,
                  workers: int | None = None,
                  executor: str | None = None,
                  warmup: bool | None = None,
                  device: str | torch.device | None = None
                  ) -> tuple[float, dict[str, FusionResult]]:
    """(geomean objective value, per-network best design), on `device`
    (the card unless the caller names another).

    With the evaluation engine enabled (default), per-network GA results
    are memoized across calls and the loop can fan out over a thread or
    spawn-safe process pool (`executor`, default the engine's); the
    process path pre-warms worker option caches over shared memory
    (`warmup`, default the engine's).
    """
    dev = resolve_device(device)
    ga = ga if ga is not None else GAConfig()
    if engine is None and engine_enabled():
        engine = DEFAULT_ENGINE
    if engine is not None:
        return engine.evaluate_pool(pool, networks, objective, reqs, ga,
                                    workers=workers, executor=executor,
                                    warmup=warmup, device=dev)
    reqs = reqs or {}
    per: dict[str, FusionResult] = {}
    logsum, n = 0.0, 0
    for name, graph in networks.items():
        res = optimize_fusion(graph, pool, objective=objective,
                              req=reqs.get(name, Requirement()), cfg=ga,
                              device=dev)
        if res is None:
            return math.inf, {}
        per[name] = res
        logsum += math.log(max(res.value, 1e-30))
        n += 1
    return math.exp(logsum / max(n, 1)), per


def anneal_pool(networks: dict[str, OperatorGraph],
                objective: str = "energy",
                pool_size: int = 8,
                reqs: dict[str, Requirement] | None = None,
                cfg: SAConfig | None = None,
                init: Sequence[Chiplet] | None = None,
                final_ga: GAConfig | None = None,
                engine: EvaluationEngine | None = None,
                device: str | torch.device | None = None) -> PoolResult:
    """The full Layer-1 SA, on `device` (the card unless the caller
    names another)."""
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else SAConfig()
    rng = random.Random(cfg.seed)
    pool = list(init) if init is not None else default_pool()[:pool_size]
    while len(pool) < pool_size:           # grow from the seed pool
        for _ in range(64):                # keep grown SKUs distinct
            cand = _mutate_chiplet(rng.choice(pool), rng)
            if cand not in pool:
                pool.append(cand)
                break
        else:                              # mutation walk stuck: fill
            cand = next((c for c in full_design_space()
                         if c not in pool), None)
            if cand is None:
                raise ValueError(
                    f"pool_size={pool_size} exceeds the "
                    f"{len(full_design_space())}-point design space")
            pool.append(cand)
    pool = pool[:pool_size]

    cur_score, cur_per = evaluate_pool(pool, networks, objective, reqs,
                                       cfg.inner_ga, engine=engine,
                                       workers=cfg.workers,
                                       executor=cfg.executor,
                                       warmup=cfg.warmup, device=dev)
    best = PoolResult(pool=list(pool), score=cur_score, per_network=cur_per)
    temp = cfg.init_temp
    for _ in range(cfg.iterations):
        cand = _neighbor(pool, rng)
        score, per = evaluate_pool(cand, networks, objective, reqs,
                                   cfg.inner_ga, engine=engine,
                                   workers=cfg.workers,
                                   executor=cfg.executor,
                                   warmup=cfg.warmup, device=dev)
        delta = (score - cur_score) / max(cur_score, 1e-30)
        if delta < 0 or rng.random() < math.exp(-delta / max(temp, 1e-9)):
            pool, cur_score, cur_per = cand, score, per
            if cur_score < best.score:
                best = PoolResult(pool=list(pool), score=cur_score,
                                  per_network=cur_per)
        temp *= cfg.cooling

    if final_ga is not None:               # full-budget re-eval of winner
        score, per = evaluate_pool(best.pool, networks, objective, reqs,
                                   final_ga, engine=engine,
                                   workers=cfg.workers,
                                   executor=cfg.executor,
                                   warmup=cfg.warmup, device=dev)
        if per:
            best = PoolResult(pool=best.pool, score=score, per_network=per)
    return best
