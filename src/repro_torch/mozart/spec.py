"""Declarative deployment specs for the Mozart codesign stack.

A `MozartSpec` names *what* to build — the networks, the deployment
scenario(s) constraining them, the objective, and the search budgets —
and `repro_torch.mozart.compile` turns it into a `Deployment` artifact.  Specs
are plain data: they serialize to JSON (`to_dict` / `from_dict`) and are
echoed verbatim into every compiled artifact, so an artifact always
records the spec that produced it.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core.fusion import GAConfig, Requirement
from repro_torch.core.operators import OperatorGraph, paper_workloads
from repro_torch.core.pool import SAConfig
from repro_torch.core.scenarios import Scenario, get_scenario

BASELINE_KINDS = ("best_homogeneous", "unconstrained")


def _resolve_scenario(s: str | Scenario | None) -> Scenario | None:
    if isinstance(s, str):
        return get_scenario(s)
    return s


def _scenario_to_jsonable(s: str | Scenario | None) -> str | dict | None:
    if isinstance(s, Scenario):
        return s.to_dict()
    return s


def _scenario_from_jsonable(s: str | dict | None) -> str | Scenario | None:
    if isinstance(s, dict):
        return Scenario.from_dict(s)
    return s


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """One network of a deployment spec.

    `workload` is either a `repro_torch.core.operators.paper_workloads` key
    (e.g. "resnet50", "opt66b_decode") or an explicit `OperatorGraph`.
    `role` selects a per-role requirement from role-aware scenarios
    (speculative decoding: "draft" / "target"); an explicit
    `requirement` overrides the scenario entirely.
    """

    workload: str | OperatorGraph
    scenario: str | Scenario | None = None
    role: str = ""
    requirement: Requirement | None = None

    def graph(self, seq: int) -> OperatorGraph:
        if isinstance(self.workload, OperatorGraph):
            return self.workload
        named = paper_workloads(seq=seq)
        try:
            return named[self.workload]
        except KeyError:
            raise KeyError(
                f"unknown workload {self.workload!r}; known: "
                f"{sorted(named)} (or pass an OperatorGraph)"
            ) from None

    def to_dict(self) -> dict:
        w = self.workload
        req = None if self.requirement is None else self.requirement.to_dict()
        return {
            "workload": w.to_dict() if isinstance(w, OperatorGraph) else w,
            "scenario": _scenario_to_jsonable(self.scenario),
            "role": self.role,
            "requirement": req,
        }

    @staticmethod
    def from_dict(d: dict) -> "NetworkSpec":
        w = d["workload"]
        req = d.get("requirement")
        return NetworkSpec(
            workload=OperatorGraph.from_dict(w) if isinstance(w, dict) else w,
            scenario=_scenario_from_jsonable(d.get("scenario")),
            role=d.get("role", ""),
            requirement=None if req is None else Requirement.from_dict(req),
        )


@dataclasses.dataclass(frozen=True)
class ResolvedSpec:
    """A `MozartSpec` lowered to exactly what `run_codesign` consumes."""

    networks: dict[str, OperatorGraph]
    reqs: dict[str, Requirement]
    objective: str
    pool_size: int
    sa: SAConfig
    ga: GAConfig
    baselines: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class MozartSpec:
    """Declarative input of `repro_torch.mozart.compile`.

    networks   — name -> NetworkSpec | OperatorGraph | workload name
    scenario   — spec-wide scenario (name or object); per-network
                 NetworkSpec.scenario overrides it
    objective  — codesign metric; defaults to the scenario's metric,
                 then "energy"
    pool_size  — Layer-1 chiplet pool size
    seq        — sequence length for named LLM workloads
    sa / ga    — Layer-1 / Layer-2 budgets (defaults: the raised,
                 benchmark-justified budgets)
    baselines  — which comparison designs to compile into the artifact
    workers / executor — evaluation fan-out, folded into `sa`
    """

    networks: Mapping[str, NetworkSpec | OperatorGraph | str]
    scenario: str | Scenario | None = None
    objective: str | None = None
    pool_size: int = 8
    seq: int = 2048
    sa: SAConfig | None = None
    ga: GAConfig | None = None
    baselines: tuple[str, ...] = BASELINE_KINDS
    workers: int | None = None
    executor: str | None = None

    def network_specs(self) -> dict[str, NetworkSpec]:
        """Entries normalized to `NetworkSpec`."""
        out: dict[str, NetworkSpec] = {}
        for name, entry in self.networks.items():
            if isinstance(entry, NetworkSpec):
                out[name] = entry
            else:
                out[name] = NetworkSpec(workload=entry)
        return out

    def scenario_for(self, net: NetworkSpec) -> Scenario | None:
        s = net.scenario if net.scenario is not None else self.scenario
        return _resolve_scenario(s)

    def resolve(self) -> ResolvedSpec:
        if not self.networks:
            raise ValueError("MozartSpec needs at least one network")
        bad = [b for b in self.baselines if b not in BASELINE_KINDS]
        if bad:
            raise ValueError(f"unknown baselines {bad}; known: {BASELINE_KINDS}")
        specs = self.network_specs()
        graphs: dict[str, OperatorGraph] = {}
        reqs: dict[str, Requirement] = {}
        metrics: list[str] = []
        for name, net in specs.items():
            graphs[name] = net.graph(self.seq)
            scen = self.scenario_for(net)
            if net.requirement is not None:
                reqs[name] = net.requirement
            elif scen is not None:
                reqs[name] = scen.requirement_for(net.role)
            else:
                reqs[name] = Requirement()
            if scen is not None:
                metrics.append(scen.metric)
        if self.objective is not None:
            objective = self.objective
        elif not metrics:
            objective = "energy"
        elif len(set(metrics)) == 1:
            objective = metrics[0]
        else:
            raise ValueError(
                f"scenarios disagree on the metric ({sorted(set(metrics))}); "
                f"set MozartSpec.objective explicitly"
            )
        sa = self.sa if self.sa is not None else SAConfig()
        if self.workers is not None:
            sa = dataclasses.replace(sa, workers=self.workers)
        if self.executor is not None:
            sa = dataclasses.replace(sa, executor=self.executor)
        ga = self.ga if self.ga is not None else GAConfig()
        return ResolvedSpec(
            networks=graphs,
            reqs=reqs,
            objective=objective,
            pool_size=self.pool_size,
            sa=sa,
            ga=ga,
            baselines=tuple(self.baselines),
        )

    def to_dict(self) -> dict:
        return {
            "networks": {name: net.to_dict() for name, net in self.network_specs().items()},
            "scenario": _scenario_to_jsonable(self.scenario),
            "objective": self.objective,
            "pool_size": self.pool_size,
            "seq": self.seq,
            "sa": None if self.sa is None else self.sa.to_dict(),
            "ga": None if self.ga is None else self.ga.to_dict(),
            "baselines": list(self.baselines),
            "workers": self.workers,
            "executor": self.executor,
        }

    @staticmethod
    def from_dict(d: dict) -> "MozartSpec":
        sa = d.get("sa")
        ga = d.get("ga")
        return MozartSpec(
            networks={name: NetworkSpec.from_dict(nd) for name, nd in d["networks"].items()},
            scenario=_scenario_from_jsonable(d.get("scenario")),
            objective=d.get("objective"),
            pool_size=d.get("pool_size", 8),
            seq=d.get("seq", 2048),
            sa=None if sa is None else SAConfig.from_dict(sa),
            ga=None if ga is None else GAConfig.from_dict(ga),
            baselines=tuple(d.get("baselines", BASELINE_KINDS)),
            workers=d.get("workers"),
            executor=d.get("executor"),
        )
