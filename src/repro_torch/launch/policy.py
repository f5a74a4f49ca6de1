"""Execution policies, as the Mozart deployment artifact carries them
(the port's copy of `repro.core.policy.OperatorPolicy`/`ExecutionPolicy`
and of `repro.mozart.deployment.load_policy`).

Per-operator-class batch sizes drive the engine's max/decode batch, the
tensor-parallel degree the mesh, and fusion groups select the fused
kernels.
"""
from __future__ import annotations

import dataclasses
import json
import os

SCHEMA = "mozart-deployment/v1"


@dataclasses.dataclass(frozen=True)
class OperatorPolicy:
    group: str
    batch: int
    tp: int
    memory: str
    chiplet: str
    fused: bool           # >1 operator in the group -> fused kernel

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "OperatorPolicy":
        return OperatorPolicy(group=d["group"], batch=d["batch"],
                              tp=d["tp"], memory=d["memory"],
                              chiplet=d["chiplet"], fused=d["fused"])


@dataclasses.dataclass
class ExecutionPolicy:
    network: str
    interval_s: float                 # target per-sample initiation interval
    operators: list[OperatorPolicy]

    @property
    def batch_agnostic_batch(self) -> int:
        bs = [p.batch for p in self.operators
              if "attention" in p.group or "scan" in p.group]
        return min(bs) if bs else 1

    @property
    def batch_sensitive_batch(self) -> int:
        bs = [p.batch for p in self.operators
              if "attention" not in p.group and "scan" not in p.group]
        return max(bs) if bs else 1

    @property
    def tp_degree(self) -> int:
        return max((p.tp for p in self.operators), default=1)

    def fusion_flags(self) -> dict[str, bool]:
        """Which fused kernels the substrate should enable."""
        flags = {"flash_attention": False, "fused_mlp": False,
                 "fused_norm": False}
        for p in self.operators:
            if not p.fused:
                continue
            if "attention" in p.group:
                flags["flash_attention"] = True
            if "mlp" in p.group:
                flags["fused_mlp"] = True
            if "norm" in p.group:
                flags["fused_norm"] = True
        return flags

    def to_dict(self) -> dict:
        return {
            "network": self.network,
            "interval_s": self.interval_s,
            "operators": [p.to_dict() for p in self.operators],
            "fusion": self.fusion_flags(),
        }

    @staticmethod
    def from_dict(d: dict) -> "ExecutionPolicy":
        pol = ExecutionPolicy(
            network=d["network"], interval_s=d["interval_s"],
            operators=[OperatorPolicy.from_dict(p) for p in d["operators"]])
        want = d.get("fusion")
        if want is not None and want != pol.fusion_flags():
            raise ValueError(
                f"policy fusion flags {want} do not match the flags "
                f"derived from its operators {pol.fusion_flags()}")
        return pol

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)


def load_policy(path: str | os.PathLike,
                network: str | None = None) -> ExecutionPolicy:
    """A policy from a `mozart-deployment/v1` artifact (its `policies`
    map; `network` names one when it holds several) or from a bare
    `ExecutionPolicy.to_json` file (`network` ignored)."""
    with open(os.fspath(path), encoding="utf-8") as f:
        blob = json.load(f)
    if blob.get("schema") != SCHEMA:
        return ExecutionPolicy.from_dict(blob)
    policies = blob["policies"]
    if network is None:
        if len(policies) != 1:
            raise ValueError(f"deployment has {len(policies)} policies "
                             f"({sorted(policies)}); name one")
        return ExecutionPolicy.from_dict(next(iter(policies.values())))
    return ExecutionPolicy.from_dict(policies[network])
