"""Layer 2: evolutionary search over tensor-fusion grouping + memory
allocation (paper §4.2).

Genome, over the *compressed* operator pipeline (repeated layers share a
template — the paper's "representative regions"):

  * boundaries[i] in {0,1}  — cut between op i and i+1 (1 = stage break);
    cuts are forced where adjacent ops have different repeat counts.
  * mem_gene[i] in MEMORY_POOL — the memory type of the group whose first
    op is i (genes of non-leading ops are silent but inherited by
    crossover, preserving high-quality fusion groups, §4.2).

Fitness is the Layer-3 iso-latency/convex-hull solve (convexhull.py) on
the fusion's stage options, whose columns live on the caller's device
(the card unless the caller names another).  The initial population is roofline-seeded
(Insight 1: memory-bound groups get fast memory, compute-bound groups get
cheap memory) and encodes Alwani-style early-layer fusion patterns.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import random
from typing import Iterable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import costmodel
from .chiplets import Chiplet
from .convexhull import (
    PipelineJob,
    PipelineSolution,
    clear_grid_cache,
    default_latency_grid,
    solve_pipeline,
    solve_pipeline_batch,
)
from .memory import DDR5, HBM3, MEMORY_POOL, MemoryType
from .operators import Operator, OperatorGraph
from .engine import engine_enabled
from .perfmodel import (
    BATCH_OPTIONS,
    F64,
    StageOptionColumns,
    StageOptionSet,
    config_grid,
    enumerate_stage_columns_by_chiplet,
    enumerate_stage_options,
    is_memory_bound,
    scale_option,
)


@dataclasses.dataclass(frozen=True)
class Requirement:
    """Latency requirements (paper Table 5). Seconds; None = unconstrained.
    ttft/tpot/e2e all constrain the end-to-end pipeline traversal P*T."""

    ttft: float | None = None
    tpot: float | None = None
    e2e: float | None = None

    @property
    def max_e2e(self) -> float | None:
        vals = [v for v in (self.ttft, self.tpot, self.e2e) if v is not None]
        return min(vals) if vals else None

    def to_dict(self) -> dict:
        return {"ttft": self.ttft, "tpot": self.tpot, "e2e": self.e2e}

    @staticmethod
    def from_dict(d: dict) -> "Requirement":
        return Requirement(ttft=d.get("ttft"), tpot=d.get("tpot"), e2e=d.get("e2e"))


@dataclasses.dataclass(frozen=True)
class Genome:
    boundaries: tuple[int, ...]  # len N-1
    mem_genes: tuple[int, ...]  # len N, index into MEMORY_POOL

    def to_dict(self) -> dict:
        return {"boundaries": list(self.boundaries), "mem_genes": list(self.mem_genes)}

    @staticmethod
    def from_dict(d: dict) -> "Genome":
        return Genome(boundaries=tuple(d["boundaries"]), mem_genes=tuple(d["mem_genes"]))


@dataclasses.dataclass(frozen=True)
class FusionGroup:
    ops: tuple[Operator, ...]
    repeat: int
    memory: MemoryType
    name: str

    def to_dict(self) -> dict:
        return {
            "ops": [o.to_dict() for o in self.ops],
            "repeat": self.repeat,
            "memory": self.memory.to_dict(),
            "name": self.name,
        }

    @staticmethod
    def from_dict(d: dict) -> "FusionGroup":
        return FusionGroup(
            ops=tuple(Operator.from_dict(o) for o in d["ops"]),
            repeat=d["repeat"],
            memory=MemoryType.from_dict(d["memory"]),
            name=d["name"],
        )


@dataclasses.dataclass
class FusionResult:
    genome: Genome
    groups: list[FusionGroup]
    solution: PipelineSolution
    value: float

    def to_dict(self) -> dict:
        return {
            "genome": self.genome.to_dict(),
            "groups": [g.to_dict() for g in self.groups],
            "solution": self.solution.to_dict(),
            "value": self.value,
        }

    @staticmethod
    def from_dict(d: dict) -> "FusionResult":
        return FusionResult(
            genome=Genome.from_dict(d["genome"]),
            groups=[FusionGroup.from_dict(g) for g in d["groups"]],
            solution=PipelineSolution.from_dict(d["solution"]),
            value=d["value"],
        )


@dataclasses.dataclass
class GAConfig:
    population: int = 10  # paper Table 4
    # Paper Table 4 uses 10 generations; the fixed-seed sweep in
    # benchmarks/bench_budget_scaling.py still finds improvement between
    # 16 and 24 generations (elitism makes the axis monotone), so the
    # default budget is 24 (~0.6 s vs 0.3 s on the dev container).
    generations: int = 24
    mutation_rate: float = 0.2
    crossover_rate: float = 0.8
    seed: int = 0
    latency_points: int = 48
    fixed_batch: int | None = None
    batches: tuple[int, ...] = BATCH_OPTIONS

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["batches"] = list(self.batches)
        return d

    @staticmethod
    def from_dict(d: dict) -> "GAConfig":
        d = dict(d)
        d["batches"] = tuple(d.get("batches", BATCH_OPTIONS))
        return GAConfig(**d)


def forced_boundaries(graph: OperatorGraph) -> tuple[int, ...]:
    """Cuts that every genome must contain (repeat-count changes)."""
    r = graph.repeats
    return tuple(1 if r[i] != r[i + 1] else 0 for i in range(len(r) - 1))


def groups_from_genome(graph: OperatorGraph, g: Genome) -> list[FusionGroup]:
    ops, reps = graph.operators, graph.repeats
    forced = forced_boundaries(graph)
    groups: list[FusionGroup] = []
    start = 0
    for i in range(len(ops)):
        last = i == len(ops) - 1
        cut = last or g.boundaries[i] or forced[i]
        if cut:
            seg = ops[start : i + 1]
            mem = MEMORY_POOL[g.mem_genes[start] % len(MEMORY_POOL)]
            groups.append(
                FusionGroup(
                    ops=tuple(seg),
                    repeat=reps[start],
                    memory=mem,
                    name="+".join(o.name for o in seg),
                )
            )
            start = i + 1
    return groups


# Per-(fusion group, SKU, device) option cache.  A plain dict rather than
# an lru_cache so the population-batch prefetch below can probe and fill
# it wholesale (one vectorized evaluation covering every missing SKU),
# with a FIFO entry bound (long-lived processes sweeping many
# networks/pools must not grow without bound).  Values are
# StageOptionColumns blocks (column tensors on the key's device + shared
# config tuple), the transport unit of the process-pool warmup below.
# The key's last element is the device, so a block built on the card is
# never served to a CPU run of the same process, nor the reverse.
# Single-writer: filled from the GA loop of one process (workers hold
# their own shard); cross-process merges go through the warmup shipment.
_chiplet_option_cache: dict[tuple, StageOptionColumns] = {}
_CHIPLET_CACHE_MAX = 500_000

# Option-cache traffic counters.  `enumerated` counts (group, SKU)
# blocks actually evaluated in this process; `installed` counts blocks
# received pre-built through the warmup transport instead.  Workers
# report both to the parent engine (`EvaluationEngine.stats()`).
_warmup_stats = {"installed": 0, "enumerated": 0}


def warmup_stats() -> dict[str, int]:
    return dict(_warmup_stats)


def _chiplet_cache_put(key: tuple, val: StageOptionColumns) -> None:
    if len(_chiplet_option_cache) >= _CHIPLET_CACHE_MAX:
        _chiplet_option_cache.pop(next(iter(_chiplet_option_cache)))
    _chiplet_option_cache[key] = val


def _chiplet_cache_key(
    ops: tuple[Operator, ...],
    repeat: int,
    chiplet: Chiplet,
    memory: MemoryType,
    fixed_batch: int | None,
    batches: tuple[int, ...],
    name: str,
    device: torch.device,
) -> tuple:
    return (ops, repeat, chiplet, memory, fixed_batch, batches, name, str(device))


def _chiplet_group_columns(
    ops: tuple[Operator, ...],
    repeat: int,
    chiplet: Chiplet,
    memory: MemoryType,
    fixed_batch: int | None,
    batches: tuple[int, ...],
    name: str,
    device: torch.device,
) -> StageOptionColumns:
    """Option columns for one fusion group on ONE chiplet SKU, on
    `device`.  Keyed per SKU so a single-SKU pool mutation (the SA
    neighbor move) re-enumerates only the new SKU's options; the other
    pool members come from cache."""
    key = _chiplet_cache_key(ops, repeat, chiplet, memory, fixed_batch, batches, name, device)
    got = _chiplet_option_cache.get(key)
    if got is None:
        _warmup_stats["enumerated"] += 1
        got = enumerate_stage_columns_by_chiplet(
            ops,
            (chiplet,),
            memories=(memory,),
            batches=batches,
            name=name,
            fixed_batch=fixed_batch,
            cost_fn=costmodel.stage_hw_cost,
            repeat=repeat,
            device=device,
        )[chiplet]
        _chiplet_cache_put(key, got)
    return got


def prefetch_population_options(
    graph: OperatorGraph,
    genomes: Sequence[Genome],
    pool: Sequence[Chiplet],
    cfg: GAConfig,
    device: str | torch.device | None = None,
) -> None:
    """Population-batched option enumeration (the Layer-2 vectorization).

    Decodes every genome of a GA population, collects the distinct fusion
    groups they induce, and fills the per-(group, SKU) option cache with
    ONE batched-columns evaluation per distinct group covering all its
    missing SKUs — instead of one scalar enumeration per
    (genome, group, SKU).  Results are bit-identical to the per-SKU path
    (the batched model is row-wise element-wise), so GA fitness values
    are unchanged; only the evaluation shape changes.  The columns stay
    on `device` (the card unless the caller names another).
    """
    dev = resolve_device(device)
    if not engine_enabled():
        return
    _prefetch_group_options(
        (gr for g in genomes for gr in groups_from_genome(graph, g)), pool, cfg, dev
    )


def _prefetch_group_options(
    groups: "Iterable[FusionGroup]", pool: Sequence[Chiplet], cfg: GAConfig, device: torch.device
) -> None:
    """Group-level core of the population prefetch: one batched-columns
    evaluation per distinct group covering all its missing SKUs."""
    batches = tuple(cfg.batches)
    # dict keeps insertion order and dedupes caller-supplied dup SKUs
    skus = tuple(dict.fromkeys(pool))
    seen: set[tuple] = set()
    for gr in groups:
        gkey = (gr.ops, gr.repeat, gr.memory, gr.name)
        if gkey in seen:
            continue
        seen.add(gkey)
        missing = [
            c
            for c in skus
            if _chiplet_cache_key(
                gr.ops, gr.repeat, c, gr.memory, cfg.fixed_batch, batches, gr.name, device
            )
            not in _chiplet_option_cache
        ]
        if not missing:
            continue
        _warmup_stats["enumerated"] += len(missing)
        grouped = enumerate_stage_columns_by_chiplet(
            gr.ops,
            tuple(missing),
            memories=(gr.memory,),
            batches=batches,
            name=gr.name,
            fixed_batch=cfg.fixed_batch,
            cost_fn=costmodel.stage_hw_cost,
            repeat=gr.repeat,
            device=device,
        )
        for c, block in grouped.items():
            _chiplet_cache_put(
                _chiplet_cache_key(
                    gr.ops, gr.repeat, c, gr.memory, cfg.fixed_batch, batches, gr.name, device
                ),
                block,
            )


# --- shared option-cache transport (process-pool warmup) --------------------


def matching_option_keys(
    pool: Sequence[Chiplet], cfg: GAConfig, device: torch.device
) -> list[tuple]:
    """Cache keys shippable to a worker evaluating `pool` under `cfg` on
    `device`: the entry's SKU is in the pool and its batch axis matches
    the GA config (the group axis is deliberately unfiltered — any group
    a worker encounters again is worth having)."""
    skus = set(pool)
    batches = tuple(cfg.batches)
    return [
        k
        for k in _chiplet_option_cache
        if k[2] in skus and k[4] == cfg.fixed_batch and k[5] == batches and k[7] == str(device)
    ]


def export_option_columns(keys: Sequence[tuple]) -> tuple[list[dict], np.ndarray]:
    """Pack cached (group, SKU) blocks for transport: one flat host
    float64 matrix with rows (t_cmp, e_dyn, p_static, hw_cost), copied off
    the device in one transfer, and a metadata list carrying each block's
    cache key (without its device) and row span.  The matrix is what
    rides shared memory; everything config-shaped is rebuilt on the
    receiving side from the key (deterministic, bit-identical)."""
    meta: list[dict] = []
    parts: list[torch.Tensor] = []
    off = 0
    for key in keys:
        block = _chiplet_option_cache.get(key)
        if block is None:
            continue
        n = len(block)
        meta.append({"key": key[:7], "off": off, "n": n, "flops": block.flops_per_sample})
        if n:
            parts.append(
                torch.stack([block.t_cmp, block.e_dyn, block.p_static, block.hw_cost_usd], dim=1)
            )
        off += n
    if not parts:
        return meta, np.empty((0, 4), dtype=np.float64)
    return meta, torch.cat(parts).cpu().numpy()


def import_option_columns(
    meta: Sequence[dict], matrix: np.ndarray, device: str | torch.device | None = None
) -> int:
    """Install transported blocks into this process's option cache on
    `device`, skipping keys already present.  The matrix is copied to the
    device once (never aliased: it may sit in a shared-memory block the
    sender unlinks).  Config tuples are rebuilt via the memoized
    `config_grid` (same enumeration the sender ran), so an installed
    block is bit-identical to enumerating locally — minus the
    roofline-model evaluation.  Returns the number of blocks installed.
    """
    dev = resolve_device(device)
    cols: torch.Tensor | None = None
    installed = 0
    for e in meta:
        key = (*e["key"], str(dev))
        if key in _chiplet_option_cache:
            continue
        ops, repeat, chiplet, memory, fixed_batch, batches, name = e["key"]
        grid = config_grid(
            ops, (chiplet,), memories=(memory,), batches=batches, fixed_batch=fixed_batch
        )
        if len(grid.cfgs) != e["n"]:  # sender/receiver model drift
            continue
        if cols is None:
            cols = torch.tensor(np.ascontiguousarray(matrix.T), dtype=F64, device=dev)
        lo, hi = e["off"], e["off"] + e["n"]
        _chiplet_cache_put(
            key,
            StageOptionColumns(
                t_cmp=cols[0, lo:hi],
                e_dyn=cols[1, lo:hi],
                p_static=cols[2, lo:hi],
                hw_cost_usd=cols[3, lo:hi],
                cfgs=grid.cfgs,
                group_name=name,
                flops_per_sample=e["flops"],
                repeat=repeat,
            ),
        )
        installed += 1
    _warmup_stats["installed"] += installed
    return installed


@functools.lru_cache(maxsize=200_000)
def _group_options_cached(
    ops: tuple[Operator, ...],
    repeat: int,
    pool: tuple[Chiplet, ...],
    memory: MemoryType,
    fixed_batch: int | None,
    batches: tuple[int, ...],
    name: str,
    device: torch.device,
) -> StageOptionSet:
    if engine_enabled():
        out = StageOptionSet.from_blocks(
            (
                _chiplet_group_columns(ops, repeat, c, memory, fixed_batch, batches, name, device)
                for c in pool
            ),
            device,
        )
        out.columns()  # build once, reused by every genome eval
        return out
    raw = enumerate_stage_options(
        ops,
        pool,
        memories=(memory,),
        batches=batches,
        name=name,
        fixed_batch=fixed_batch,
        vectorize=False,
    )
    priced = costmodel.price_stage_options(raw)
    return StageOptionSet((scale_option(o, repeat) for o in priced), device)


def clear_option_caches() -> None:
    _chiplet_option_cache.clear()
    _group_options_cached.cache_clear()
    clear_grid_cache()
    _warmup_stats["installed"] = 0
    _warmup_stats["enumerated"] = 0


def stage_options_for_groups(
    groups: Sequence[FusionGroup],
    pool: Sequence[Chiplet],
    cfg: GAConfig,
    device: str | torch.device | None = None,
) -> list[StageOptionSet]:
    dev = resolve_device(device)
    return [
        _group_options_cached(
            g.ops, g.repeat, tuple(pool), g.memory, cfg.fixed_batch, tuple(cfg.batches), g.name, dev
        )
        for g in groups
    ]


def evaluate_genome(
    graph: OperatorGraph,
    genome: Genome,
    pool: Sequence[Chiplet],
    objective: str,
    req: Requirement,
    cfg: GAConfig,
    _solution_cache: dict | None = None,
    device: str | torch.device | None = None,
) -> FusionResult | None:
    dev = resolve_device(device)
    groups = groups_from_genome(graph, genome)
    # Memory genes of non-leading ops are silent (§4.2): distinct genomes
    # can decode to identical fusion groups.  Collapse them onto one
    # Layer-3 solve via the caller-scoped solution cache.
    key = tuple(groups) if _solution_cache is not None else None
    if key is not None and key in _solution_cache:
        sol = _solution_cache[key]
        if sol is None:
            return None
        return FusionResult(genome=genome, groups=groups, solution=sol, value=sol.value)
    options = stage_options_for_groups(groups, pool, cfg, dev)
    if any(not o for o in options):
        if key is not None:
            _solution_cache[key] = None
        return None
    grid = default_latency_grid(options, n=cfg.latency_points)
    n_stages = sum(g.repeat for g in groups)
    sol = solve_pipeline(
        options, grid, objective=objective, max_e2e=req.max_e2e, n_stages=n_stages, device=dev
    )
    if key is not None:
        _solution_cache[key] = sol
    if sol is None:
        return None
    return FusionResult(genome=genome, groups=groups, solution=sol, value=sol.value)


def evaluate_genomes(
    graph: OperatorGraph,
    genomes: Sequence[Genome],
    pool: Sequence[Chiplet],
    objective: str,
    req: Requirement,
    cfg: GAConfig,
    _solution_cache: dict,
    device: str | torch.device | None = None,
) -> dict[Genome, FusionResult | None]:
    """Generation-batched Layer-3: one `solve_pipeline_batch` call for a
    whole GA generation instead of a Python loop of per-genome
    `solve_pipeline` calls.

    Genomes are decoded, deduped onto distinct fusion plans (memory
    genes of non-leading ops are silent, §4.2), and every plan missing
    from the solution cache becomes one PipelineJob sharing the batched
    sweep.  Results — including tie-breaks — are bit-identical to
    calling `evaluate_genome` per genome, so the GA trajectory is
    unchanged; only the evaluation shape is.  Everything runs on `device`
    (the card unless the caller names another) until the winners.
    """
    dev = resolve_device(device)
    decoded: list[tuple[Genome, list[FusionGroup], tuple]] = []
    for g in dict.fromkeys(genomes):
        groups = groups_from_genome(graph, g)
        decoded.append((g, groups, tuple(groups)))
    if engine_enabled():
        _prefetch_group_options((gr for _, groups, _ in decoded for gr in groups), pool, cfg, dev)
    jobs: list[PipelineJob] = []
    job_keys: list[tuple] = []
    queued: set[tuple] = set()
    for g, groups, key in decoded:
        if key in _solution_cache or key in queued:
            continue
        options = stage_options_for_groups(groups, pool, cfg, dev)
        if any(not o for o in options):
            _solution_cache[key] = None
            continue
        queued.add(key)
        grid = default_latency_grid(options, n=cfg.latency_points)
        jobs.append(
            PipelineJob(
                options, grid, max_e2e=req.max_e2e, n_stages=sum(gr.repeat for gr in groups)
            )
        )
        job_keys.append(key)
    if jobs:
        sols = solve_pipeline_batch(jobs, objective=objective, device=dev)
        for key, sol in zip(job_keys, sols):
            _solution_cache[key] = sol
    out: dict[Genome, FusionResult | None] = {}
    for g, groups, key in decoded:
        sol = _solution_cache[key]
        out[g] = (
            None
            if sol is None
            else FusionResult(genome=g, groups=groups, solution=sol, value=sol.value)
        )
    return out


# --- seeding ----------------------------------------------------------------


def _roofline_seed(graph: OperatorGraph, pool: Sequence[Chiplet], fuse: bool) -> Genome:
    """Insight-1 seed: group while intermediates fit the biggest GLB; give
    memory-bound groups HBM, compute-bound groups DDR5."""
    ops, reps = graph.operators, graph.repeats
    forced = forced_boundaries(graph)
    glb = max(c.glb_bytes for c in pool) / 2
    ref_chiplet = sorted(pool, key=lambda c: c.n_pes)[len(pool) // 2]
    bounds = []
    for i in range(len(ops) - 1):
        if not fuse:
            bounds.append(1)
        else:
            spill = ops[i].act_out_bytes > glb
            bounds.append(1 if (forced[i] or spill) else 0)
    hbm_i = MEMORY_POOL.index(HBM3)
    ddr_i = MEMORY_POOL.index(DDR5)
    genes = [hbm_i if is_memory_bound(o, ref_chiplet, HBM3) else ddr_i for o in ops]
    return Genome(boundaries=tuple(bounds), mem_genes=tuple(genes))


def _mutate(g: Genome, rng: random.Random, rate: float) -> Genome:
    b = list(g.boundaries)
    m = list(g.mem_genes)
    for i in range(len(b)):
        if rng.random() < rate:
            b[i] ^= 1
    for i in range(len(m)):
        if rng.random() < rate:
            m[i] = rng.randrange(len(MEMORY_POOL))
    return Genome(tuple(b), tuple(m))


def _crossover(a: Genome, b: Genome, rng: random.Random) -> Genome:
    """Single-point crossover preserving contiguous fusion groups (§4.2)."""
    if len(a.boundaries) == 0:
        return a
    cut = rng.randrange(len(a.boundaries) + 1)
    return Genome(
        a.boundaries[:cut] + b.boundaries[cut:], a.mem_genes[: cut + 1] + b.mem_genes[cut + 1 :]
    )


def initial_population(
    graph: OperatorGraph, pool: Sequence[Chiplet], cfg: GAConfig, rng: random.Random | None = None
) -> list[Genome]:
    """The GA's deterministic generation-0 population: the two roofline
    seeds plus seeded mutations of the fused seed.  Factored out so the
    process-pool warmup can decode the exact genomes a worker's GA will
    evaluate first — without running the GA.  When `rng` is supplied
    (by `optimize_fusion`), its state advances exactly as the inlined
    seeding loop used to, preserving fixed-seed GA trajectories."""
    rng = rng if rng is not None else random.Random(cfg.seed)
    seeds = [_roofline_seed(graph, pool, fuse=True), _roofline_seed(graph, pool, fuse=False)]
    pop: list[Genome] = list(seeds)
    while len(pop) < cfg.population:
        pop.append(_mutate(seeds[0], rng, 0.3))
    return pop


def optimize_fusion(
    graph: OperatorGraph,
    pool: Sequence[Chiplet],
    objective: str = "energy",
    req: Requirement | None = None,
    cfg: GAConfig | None = None,
    device: str | torch.device | None = None,
) -> FusionResult | None:
    """The full Layer-2 GA on `device` (the card unless the caller names
    another).  Returns the best feasible FusionResult."""
    dev = resolve_device(device)
    req = req if req is not None else Requirement()
    cfg = cfg if cfg is not None else GAConfig()
    rng = random.Random(cfg.seed)
    n = len(graph.operators)

    pop = initial_population(graph, pool, cfg, rng)

    cache: dict[Genome, FusionResult | None] = {}
    solution_cache: dict = {} if engine_enabled() else None

    def fit(g: Genome) -> float:
        if g not in cache:
            cache[g] = evaluate_genome(
                graph, g, pool, objective, req, cfg, _solution_cache=solution_cache, device=dev
            )
        r = cache[g]
        return math.inf if r is None else r.value

    def batch_eval(genomes: Sequence[Genome]) -> None:
        """Evaluate a whole generation: batched option enumeration across
        every distinct fusion group first, then ONE generation-batched
        Layer-3 solve (`evaluate_genomes`) covering every distinct
        fusion plan.  Selection/crossover/mutation below never touch the
        rng during evaluation, so the GA trajectory is identical to
        scalar per-genome evaluation."""
        todo = [g for g in dict.fromkeys(genomes) if g not in cache]
        if not todo:
            return
        if solution_cache is not None:
            # evaluate_genomes prefetches options for the decoded groups
            # itself (one decode pass shared with the solve batch).
            cache.update(
                evaluate_genomes(graph, todo, pool, objective, req, cfg, solution_cache, device=dev)
            )
        else:
            for g in todo:
                fit(g)

    for _ in range(cfg.generations):
        batch_eval(pop)
        scored = sorted(pop, key=fit)
        elite = scored[: max(2, cfg.population // 5)]
        nxt = list(elite)
        while len(nxt) < cfg.population:
            if rng.random() < cfg.crossover_rate and len(scored) >= 2:
                child = _crossover(rng.choice(scored[:5]), rng.choice(scored[:5]), rng)
            else:
                child = rng.choice(elite)
            nxt.append(_mutate(child, rng, cfg.mutation_rate))
        pop = nxt

    batch_eval(pop)  # final generation's children
    best = min(pop, key=fit)
    res = cache.get(best)
    if res is None:
        for g in sorted(cache, key=fit):
            if cache[g] is not None:
                return cache[g]
    return res
