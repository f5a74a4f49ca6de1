"""Compiled deployment artifacts: spec in, serializable `Deployment` out.

`compile(spec)` runs the four-layer Mozart stack (SA pool -> GA fusion ->
iso-latency convex hull -> P&R) for every network of a `MozartSpec`,
extracts one `ExecutionPolicy` per network, compiles the requested
baseline designs, and returns a `Deployment`.  The artifact round-trips
through JSON (`Deployment.save` / `load`): chiplet pool, fusion
solutions, per-stage configs, P&R placements, policies, and baselines
all reload bit-exact, so one codesign run becomes a reusable artifact —
CI can diff it, and `repro_torch.launch.serve --policy <artifact>`
consumes it.  With `serve --replicas N` the same artifact drives a
multi-replica `serving.cluster.ServingCluster`: the policy's TP layout
is kept intact inside each replica while the replicas are mapped onto
disjoint slices of the mesh's "data" axis.  The schema is the reference
package's: for a fixed seed `compile(spec, device="cpu").to_json()` is
byte-identical to the reference's, and either package reads the other's
artifacts.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import torch

from repro_torch.core.chiplets import Chiplet
from repro_torch.core.codesign import (
    BasicDesign,
    best_homogeneous_design,
    chiplet_reuse,
    run_codesign,
    unconstrained_design,
)
from repro_torch.core.policy import ExecutionPolicy, policy_from_design

from ..device import resolve_device
from .spec import MozartSpec

SCHEMA = "mozart-deployment/v1"


@dataclasses.dataclass
class Deployment:
    """The output artifact of one `compile` run.

    designs    — per-network composed BASICs (fusion + stage configs + P&R)
    policies   — per-network execution policies for the serving substrate
    baselines  — per-network {"best_homogeneous": ..., "unconstrained": ...}
                 comparison designs (entries may be None when infeasible)
    spec       — the declarative `MozartSpec` echo (plain JSON dict)
    """

    objective: str
    pool: list[Chiplet]
    designs: dict[str, BasicDesign]
    policies: dict[str, ExecutionPolicy]
    baselines: dict[str, dict[str, BasicDesign | None]]
    spec: dict

    # -- accessors ------------------------------------------------------

    @property
    def networks(self) -> list[str]:
        return list(self.designs)

    def pool_labels(self) -> list[str]:
        return [c.label for c in self.pool]

    def chiplet_reuse(self) -> dict[str, int]:
        """How many BASIC designs use each pool chiplet (NRE sharing);
        keys in pipeline-stage order, deterministic across runs."""
        return chiplet_reuse(self.designs.values())

    def policy(self, network: str | None = None) -> ExecutionPolicy:
        """One network's policy; with one network the name is optional."""
        return _pick(self.policies, network)

    def best_homogeneous(self, network: str) -> BasicDesign | None:
        return self.baselines.get(network, {}).get("best_homogeneous")

    def unconstrained(self, network: str) -> BasicDesign | None:
        return self.baselines.get(network, {}).get("unconstrained")

    # -- paper-style metric reductions ----------------------------------

    def metrics(self) -> dict[str, dict[str, float]]:
        return {name: d.metrics for name, d in self.designs.items()}

    def summary(self) -> dict:
        """Per-network objective values and baseline ratios, plus the
        ecosystem geomean — the numbers the paper's tables report.

        vs_best_homogeneous > 1 means the composed BASIC beats the best
        single-SKU accelerator by that factor; vs_unconstrained >= 1 is
        the price of the shared pool vs unlimited chiplet variety.
        """
        per: dict[str, dict] = {}
        logsum = 0.0
        for name, d in self.designs.items():
            v = d.fusion.value
            logsum += math.log(max(v, 1e-30))
            row: dict = {
                "value": v,
                "energy_per_sample": d.fusion.solution.energy_per_sample,
                "throughput": d.fusion.solution.throughput,
                "pnr_feasible": d.pnr.feasible,
            }
            homog = self.best_homogeneous(name)
            if homog is not None:
                row["vs_best_homogeneous"] = homog.fusion.value / v
            unc = self.unconstrained(name)
            if unc is not None:
                row["vs_unconstrained"] = v / unc.fusion.value
            per[name] = row
        n = max(len(self.designs), 1)
        return {
            "objective": self.objective,
            "geomean_value": math.exp(logsum / n),
            "per_network": per,
            "chiplet_reuse": self.chiplet_reuse(),
        }

    # -- (de)serialization ----------------------------------------------

    def to_dict(self) -> dict:
        return {
            "schema": SCHEMA,
            "objective": self.objective,
            "spec": self.spec,
            "pool": [c.to_dict() for c in self.pool],
            "designs": {n: d.to_dict() for n, d in self.designs.items()},
            "policies": {n: p.to_dict() for n, p in self.policies.items()},
            "baselines": {
                n: {kind: None if d is None else d.to_dict() for kind, d in per.items()}
                for n, per in self.baselines.items()
            },
        }

    @staticmethod
    def from_dict(d: dict) -> "Deployment":
        schema = d.get("schema")
        if schema != SCHEMA:
            raise ValueError(
                f"not a mozart deployment artifact (schema={schema!r}, "
                f"expected {SCHEMA!r})"
            )
        return Deployment(
            objective=d["objective"],
            pool=[Chiplet.from_dict(c) for c in d["pool"]],
            designs={n: BasicDesign.from_dict(b) for n, b in d["designs"].items()},
            policies={n: ExecutionPolicy.from_dict(p) for n, p in d["policies"].items()},
            baselines={
                n: {
                    kind: None if b is None else BasicDesign.from_dict(b)
                    for kind, b in per.items()
                }
                for n, per in d["baselines"].items()
            },
            spec=d.get("spec", {}),
        )

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path: str | os.PathLike) -> str:
        path = os.fspath(path)
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())
            f.write("\n")
        return path


def _pick(policies: dict, network: str | None):
    """One entry of a policies map; with one entry the name is optional."""
    if network is None:
        if len(policies) != 1:
            raise ValueError(
                f"deployment has {len(policies)} policies "
                f"({sorted(policies)}); name one"
            )
        return next(iter(policies.values()))
    return policies[network]


def compile(spec: MozartSpec, device: str | torch.device | None = None) -> Deployment:
    """Run the full four-layer stack for a declarative spec, its numerics
    on `device` (the card unless the caller names another; with no card,
    no device raises).

    Raises RuntimeError when any network of the spec has no feasible
    design under its requirement — an artifact is only produced when the
    whole ecosystem closed.
    """
    dev = resolve_device(device)
    rs = spec.resolve()
    result = run_codesign(
        rs.networks,
        objective=rs.objective,
        pool_size=rs.pool_size,
        reqs=rs.reqs,
        sa=rs.sa,
        final_ga=rs.ga,
        device=dev,
    )
    missing = sorted(set(rs.networks) - set(result.designs))
    if missing:
        raise RuntimeError(
            f"no feasible design for {missing} under objective "
            f"{rs.objective!r}; relax the requirement or raise budgets"
        )
    policies = {name: policy_from_design(d) for name, d in result.designs.items()}
    baselines: dict[str, dict[str, BasicDesign | None]] = {}
    for name, graph in rs.networks.items():
        per: dict[str, BasicDesign | None] = {}
        if "best_homogeneous" in rs.baselines:
            per["best_homogeneous"] = best_homogeneous_design(
                graph,
                objective=rs.objective,
                req=rs.reqs[name],
                ga=rs.ga,
                device=dev,
            )
        if "unconstrained" in rs.baselines:
            per["unconstrained"] = unconstrained_design(
                graph,
                objective=rs.objective,
                req=rs.reqs[name],
                ga=rs.ga,
                device=dev,
            )
        baselines[name] = per
    return Deployment(
        objective=rs.objective,
        pool=list(result.pool),
        designs=dict(result.designs),
        policies=policies,
        baselines=baselines,
        spec=spec.to_dict(),
    )


def load(path: str | os.PathLike) -> Deployment:
    """Reload a saved `Deployment` artifact."""
    with open(os.fspath(path), encoding="utf-8") as f:
        return Deployment.from_dict(json.load(f))


def load_policy(
    path: str | os.PathLike,
    network: str | None = None,
) -> ExecutionPolicy:
    """A policy from either a full deployment artifact or a bare
    `ExecutionPolicy.to_json` file.

    With a deployment artifact and no `network`, a single-network
    artifact yields its only policy; multi-network artifacts require the
    name.  Bare policy files ignore `network`.  Only the artifact's
    `policies` map is read (each through `ExecutionPolicy.from_dict`,
    which re-checks the fusion flags), so an artifact of either package
    loads to the same policy without compiling or checking its designs.
    """
    with open(os.fspath(path), encoding="utf-8") as f:
        blob = json.load(f)
    if blob.get("schema") == SCHEMA:
        return ExecutionPolicy.from_dict(_pick(blob["policies"], network))
    return ExecutionPolicy.from_dict(blob)
