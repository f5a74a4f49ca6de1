"""Mozart solution -> execution policy for the serving substrate.

The paper deploys its decisions as silicon; this framework additionally
deploys them as *execution policies* on the card:

  * per-operator-class batch size (Insight 2's non-uniform batching) drives
    the serving engine's microbatch scheduler;
  * tensor-parallel degree per stage drives sharding choices;
  * fusion groups map onto the fused CUDA kernels (flash attention etc.).

Policies are part of the `repro_torch.mozart` deployment artifact: a
compiled `Deployment` carries one `ExecutionPolicy` per network, the
whole artifact round-trips through JSON (`ExecutionPolicy.to_json` /
`policy_from_json`), and `repro_torch.launch.serve --policy <artifact>`
consumes it — fusion flags select the fused kernels, the batch split
sets the engine's max/decode batch, and the TP degree feeds mesh setup.
The artifact's schema is the reference package's, so either package's
artifact loads to the same policy in the other.
"""
from __future__ import annotations

import dataclasses
import json

from .codesign import BasicDesign


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
        """Widest per-stage tensor-parallel degree — the model-axis size
        the serving mesh must provide."""
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
            # Derived, re-checked on load; kept in the JSON so the
            # artifact is self-describing for non-Python consumers.
            "fusion": self.fusion_flags(),
        }

    @staticmethod
    def from_dict(d: dict) -> "ExecutionPolicy":
        pol = ExecutionPolicy(
            network=d["network"], interval_s=d["interval_s"],
            operators=[OperatorPolicy.from_dict(p)
                       for p in d["operators"]])
        want = d.get("fusion")
        if want is not None and want != pol.fusion_flags():
            raise ValueError(
                f"policy fusion flags {want} do not match the flags "
                f"derived from its operators {pol.fusion_flags()}")
        return pol

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)


def policy_from_json(text: str) -> ExecutionPolicy:
    """Parse `ExecutionPolicy.to_json` output back (exact round-trip)."""
    return ExecutionPolicy.from_dict(json.loads(text))


def policy_from_design(design: BasicDesign) -> ExecutionPolicy:
    ops = []
    for st in design.fusion.solution.stages:
        ops.append(OperatorPolicy(
            group=st.group_name, batch=st.cfg.batch, tp=st.cfg.tp,
            memory=st.cfg.memory.name, chiplet=st.cfg.chiplet.label,
            fused="+" in st.group_name))
    return ExecutionPolicy(network=design.network,
                           interval_s=design.fusion.solution.T,
                           operators=ops)
