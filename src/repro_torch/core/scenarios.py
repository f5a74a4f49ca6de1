"""Deployment scenarios & constraints (paper §6.2, Tables 2 and 5).

Constraint-aware system-level optimization: each scenario fixes latency
requirements and the metric of record, and the codesign layers search
within them.  Scenarios are first-class, named, and serializable so a
declarative `repro_torch.mozart.MozartSpec` can select them by name
(`get_scenario("chatbot")`); speculative decoding is a `Scenario` like
the other four, with per-role (draft / target) requirement handling.
"""
from __future__ import annotations

import dataclasses

from .fusion import Requirement

# Paper Table 5 — latency requirements of workloads.
CHATBOT = Requirement(ttft=2.5, tpot=0.15)
SUMMARIZATION = Requirement(ttft=15.0, tpot=0.15)
AV_FAST = Requirement(e2e=0.010)       # 10 ms DET deadline
AV_REALTIME = Requirement(e2e=0.033)   # 33 ms / 30 FPS

# Speculative decoding (paper §6.2.1): OPT-66B target + OPT-1.3B draft,
# token acceptance rate 5.6 with k >= 5, realized speedup capped at 2x.
SPECDEC_TAR = 5.6
SPECDEC_K = 5
SPECDEC_SPEEDUP_CAP = 2.0


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    metric: str                    # objective for the codesign search
    requirement: Requirement
    description: str = ""

    # Roles a network can play in this scenario; () = role-free.
    roles: tuple[str, ...] = ()

    def requirement_for(self, role: str = "") -> Requirement:
        """Latency requirement for one network of the scenario.  Plain
        scenarios are role-free and return their single requirement."""
        if role and self.roles and role not in self.roles:
            raise ValueError(
                f"scenario {self.name!r} has roles {self.roles}, "
                f"not {role!r}")
        return self.requirement

    def to_dict(self) -> dict:
        return {"kind": "basic", "name": self.name, "metric": self.metric,
                "requirement": self.requirement.to_dict(),
                "description": self.description,
                "roles": list(self.roles)}

    @staticmethod
    def from_dict(d: dict) -> "Scenario":
        kind = d.get("kind", "basic")
        req = Requirement.from_dict(d["requirement"])
        if kind == "spec_decode":
            return SpecDecodeScenario(
                name=d["name"], metric=d["metric"], requirement=req,
                description=d.get("description", ""),
                roles=tuple(d.get("roles", ("draft", "target"))),
                tar=d.get("tar", SPECDEC_TAR), k=d.get("k", SPECDEC_K),
                speedup_cap=d.get("speedup_cap", SPECDEC_SPEEDUP_CAP))
        return Scenario(name=d["name"], metric=d["metric"],
                        requirement=req,
                        description=d.get("description", ""),
                        roles=tuple(d.get("roles", ())))


@dataclasses.dataclass(frozen=True)
class SpecDecodeScenario(Scenario):
    """Speculative decoding as a first-class scenario (paper §6.2.1).

    Two networks participate: a latency-critical *draft* model decoding
    k tokens serially, and a throughput-oriented *target* model verifying
    the k+1-token window in one batched pass (Insight 3).  The scenario's
    base `requirement` is the per-accepted-token QoS (e.g. chatbot TPOT);
    `requirement_for` splits one iteration's budget into per-role
    deadlines: TAR tokens land per iteration on average, so the iteration
    budget is `accepted * tpot`, divided equally over the k serial draft
    steps and the single verify pass (the paper's Fig. 11 protocol uses
    the same equal split against its capped token rate).
    """
    roles: tuple[str, ...] = ("draft", "target")
    tar: float = SPECDEC_TAR
    k: int = SPECDEC_K
    speedup_cap: float = SPECDEC_SPEEDUP_CAP

    @property
    def accepted_per_iteration(self) -> float:
        return min(self.tar, self.k + 1)

    def _slot(self) -> float:
        tpot = self.requirement.max_e2e
        if tpot is None:
            raise ValueError(
                "spec-decode scenario needs a finite base requirement")
        return self.accepted_per_iteration * tpot / (self.k + 1)

    def requirement_for(self, role: str = "") -> Requirement:
        if not role:
            return self.requirement
        if role == "draft":
            # k serial single-token decodes per iteration.
            return Requirement(tpot=self._slot())
        if role == "target":
            # one batched verify pass over the k+1-token window.
            return Requirement(e2e=self._slot())
        raise ValueError(
            f"scenario {self.name!r} has roles {self.roles}, not {role!r}")

    def to_dict(self) -> dict:
        d = super().to_dict()
        d.update(kind="spec_decode", tar=self.tar, k=self.k,
                 speedup_cap=self.speedup_cap)
        return d


DATACENTER_CHATBOT = Scenario("chatbot", "energy_cost", CHATBOT,
                              "OPT-66B interactive serving")
DATACENTER_SUMMARIZATION = Scenario("summarization", "energy_cost",
                                    SUMMARIZATION, "OPT-66B summarization")
AUTONOMOUS_VEHICLE_10MS = Scenario("av_10ms", "energy_cost", AV_FAST,
                                   "perception backbone, 10 ms DET")
AUTONOMOUS_VEHICLE_33MS = Scenario("av_33ms", "energy_cost", AV_REALTIME,
                                   "perception backbone, 33 ms DET")
SPECULATIVE_DECODING = SpecDecodeScenario(
    "spec_decode", "energy_cost", CHATBOT,
    "OPT-66B target + OPT-1.3B draft, TAR 5.6, k>=5, 2x speedup cap")

SCENARIOS: dict[str, Scenario] = {
    s.name: s for s in (DATACENTER_CHATBOT, DATACENTER_SUMMARIZATION,
                        AUTONOMOUS_VEHICLE_10MS, AUTONOMOUS_VEHICLE_33MS,
                        SPECULATIVE_DECODING)
}


def get_scenario(name: str) -> Scenario:
    """Look a scenario up by name (the `MozartSpec.scenario` strings)."""
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}"
        ) from None


def spec_decode_step_latency(t_draft_token: float, t_verify_batch: float,
                             k: int = SPECDEC_K) -> float:
    """One speculative iteration: draft k tokens serially, verify batched."""
    return k * t_draft_token + t_verify_batch


def spec_decode_throughput(t_draft_token: float, t_verify_batch: float,
                           tar: float = SPECDEC_TAR,
                           k: int = SPECDEC_K) -> float:
    """Accepted tokens/s: TAR tokens land per iteration on average."""
    t_iter = spec_decode_step_latency(t_draft_token, t_verify_batch, k)
    return min(tar, k + 1) / t_iter
