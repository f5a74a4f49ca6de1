"""The Mozart hierarchical codesign flow (paper Fig. 5).

Layer 1 (pool.anneal_pool)      — SA over chiplet pool composition
Layer 2 (fusion.optimize_fusion)— GA over tensor fusion + memory allocation
Layer 3 (convexhull.solve_pipeline) — iso-latency + modified convex hull
Layer 4 (pnr.place_and_route)   — physical feasibility + footprint

This module is the *mechanism* layer.  The supported entry point for
running the stack is the `repro_torch.mozart` facade: declare a
`MozartSpec` (networks, scenario, objective, budgets) and call
`mozart.compile(spec)`, which drives the functions below and returns a
serializable `Deployment` artifact (designs, policies, baselines).
Every entry point takes `device` (the card unless the caller names
another): the stack's numerics run there, the search itself on the host.

`design_for_network` runs Layers 2–4 for one network on a fixed pool;
`run_codesign` runs the whole stack and returns the ecosystem + BASICs.
Both remain public for low-level/benchmark use.

Default search budgets are the raised, benchmark-justified ones
(SAConfig.iterations=16, GAConfig.generations=24 — see
benchmarks/bench_budget_scaling.py), not the paper's Table 4 toy
settings; pass explicit configs to reproduce the paper budgets.  The
per-network evaluation fan-out is controlled by `SAConfig.workers` /
`SAConfig.executor` (or the `EvaluationEngine`'s defaults); with the
process executor, `SAConfig.warmup` (default on) shares the per-SKU
option cache across workers via a pre-spawn shared-memory warmup.
Layer-3 runs generation-batched through
`convexhull.solve_pipeline_batch` (its `batch_solve=False` restores the
per-genome loop); every knob is bit-identical for a fixed seed.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import torch

from ..device import resolve_device
from .chiplets import Chiplet, default_pool, full_design_space
from .engine import DEFAULT_ENGINE, EvaluationEngine, engine_enabled
from .fusion import (FusionResult, GAConfig, Requirement, optimize_fusion)
from .operators import OperatorGraph
from .pnr import PnrResult, place_and_route
from .pool import PoolResult, SAConfig, anneal_pool


@dataclasses.dataclass
class BasicDesign:
    """A composed BASIC: fusion plan + stage configs + physical layout."""
    network: str
    fusion: FusionResult
    pnr: PnrResult

    @property
    def metrics(self) -> dict[str, float]:
        m = self.fusion.solution.metrics()
        m["pnr_area_mm2"] = self.pnr.area_mm2
        m["pnr_feasible"] = float(self.pnr.feasible)
        return m

    def to_dict(self) -> dict:
        return {"network": self.network, "fusion": self.fusion.to_dict(),
                "pnr": self.pnr.to_dict()}

    @staticmethod
    def from_dict(d: dict) -> "BasicDesign":
        return BasicDesign(network=d["network"],
                           fusion=FusionResult.from_dict(d["fusion"]),
                           pnr=PnrResult.from_dict(d["pnr"]))


@dataclasses.dataclass
class CodesignResult:
    pool: list[Chiplet]
    designs: dict[str, BasicDesign]
    objective: str

    def pool_labels(self) -> list[str]:
        return [c.label for c in self.pool]

    def chiplet_reuse(self) -> dict[str, int]:
        return chiplet_reuse(self.designs.values())

    def to_dict(self) -> dict:
        return {"pool": [c.to_dict() for c in self.pool],
                "designs": {n: d.to_dict()
                            for n, d in self.designs.items()},
                "objective": self.objective}

    @staticmethod
    def from_dict(d: dict) -> "CodesignResult":
        return CodesignResult(
            pool=[Chiplet.from_dict(c) for c in d["pool"]],
            designs={n: BasicDesign.from_dict(b)
                     for n, b in d["designs"].items()},
            objective=d["objective"])


def chiplet_reuse(designs: Iterable[BasicDesign]) -> dict[str, int]:
    """How many BASIC designs use each pool chiplet (NRE amortization).
    Keys appear in pipeline-stage order (deterministic across runs)."""
    reuse: dict[str, int] = {}
    for d in designs:
        used = dict.fromkeys(o.cfg.chiplet.label
                             for o in d.fusion.solution.stages)
        for u in used:
            reuse[u] = reuse.get(u, 0) + 1
    return reuse


def design_for_network(graph: OperatorGraph,
                       pool: Sequence[Chiplet],
                       objective: str = "energy",
                       req: Requirement | None = None,
                       ga: GAConfig | None = None,
                       engine: EvaluationEngine | None = None,
                       device: str | torch.device | None = None
                       ) -> BasicDesign | None:
    """Layers 2-4 for one network on a fixed chiplet pool."""
    dev = resolve_device(device)
    req = req if req is not None else Requirement()
    ga = ga if ga is not None else GAConfig()
    if engine is None and engine_enabled():
        engine = DEFAULT_ENGINE
    if engine is not None:
        fr = engine.evaluate_network(pool, graph, objective, req, ga,
                                     device=dev)
    else:
        fr = optimize_fusion(graph, pool, objective=objective, req=req,
                             cfg=ga, device=dev)
    if fr is None:
        return None
    pnr = place_and_route(fr.solution.stages)
    return BasicDesign(network=graph.network, fusion=fr, pnr=pnr)


def run_codesign(networks: dict[str, OperatorGraph],
                 objective: str = "energy",
                 pool_size: int = 8,
                 reqs: dict[str, Requirement] | None = None,
                 sa: SAConfig | None = None,
                 final_ga: GAConfig | None = None,
                 engine: EvaluationEngine | None = None,
                 device: str | torch.device | None = None) -> CodesignResult:
    """The full four-layer Mozart flow, on `device` (the card unless the
    caller names another)."""
    dev = resolve_device(device)
    sa = sa if sa is not None else SAConfig()
    final_ga = final_ga if final_ga is not None else GAConfig()
    pr: PoolResult = anneal_pool(networks, objective=objective,
                                 pool_size=pool_size, reqs=reqs, cfg=sa,
                                 final_ga=final_ga, engine=engine,
                                 device=dev)
    designs: dict[str, BasicDesign] = {}
    reqs = reqs or {}
    # The anneal's final full-budget re-eval just populated the engine
    # cache for (pr.pool, network, final_ga), so this loop only pays for
    # the Layer-4 P&R.
    for name, graph in networks.items():
        d = design_for_network(graph, pr.pool, objective=objective,
                               req=reqs.get(name, Requirement()),
                               ga=final_ga, engine=engine, device=dev)
        if d is not None:
            designs[name] = d
    return CodesignResult(pool=pr.pool, designs=designs, objective=objective)


def unconstrained_design(graph: OperatorGraph,
                         objective: str = "energy",
                         req: Requirement | None = None,
                         ga: GAConfig | None = None,
                         device: str | torch.device | None = None
                         ) -> BasicDesign | None:
    """Upper bound: unlimited chiplet variety (paper's 'Heterogeneous
    BASIC (unconstrained)') — the whole 96-point design space as the pool."""
    return design_for_network(graph, full_design_space(), objective=objective,
                              req=req, ga=ga, device=device)


def homogeneous_design(graph: OperatorGraph,
                       chiplet: Chiplet,
                       objective: str = "energy",
                       req: Requirement | None = None,
                       ga: GAConfig | None = None,
                       device: str | torch.device | None = None
                       ) -> BasicDesign | None:
    """Baseline: a single chiplet SKU for every stage (paper's
    'Homogeneous BASIC' / 'Homogeneous ASIC' paradigms)."""
    ga = ga or GAConfig()
    return design_for_network(graph, [chiplet], objective=objective,
                              req=req, ga=ga, device=device)


def best_homogeneous_design(graph: OperatorGraph,
                            candidates: Sequence[Chiplet] | None = None,
                            objective: str = "energy",
                            req: Requirement | None = None,
                            ga: GAConfig | None = None,
                            device: str | torch.device | None = None
                            ) -> BasicDesign | None:
    """The best single-SKU accelerator — the fair homogeneous baseline.

    The baseline runs at the caller's GA budget (default: the full
    `GAConfig()` budget) so it is searched as hard as the heterogeneous
    design it is compared against; a reduced budget here would bias the
    comparison in Mozart's favor.
    """
    ga = ga if ga is not None else GAConfig()
    cands = list(candidates) if candidates is not None else default_pool()
    best: BasicDesign | None = None
    for c in cands:
        d = homogeneous_design(graph, c, objective=objective, req=req, ga=ga,
                               device=device)
        if d is None:
            continue
        if best is None or d.fusion.value < best.fusion.value:
            best = d
    return best
