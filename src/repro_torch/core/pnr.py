"""Layer 4: place-and-route feasibility + footprint minimization (§4.4).

Places the accelerator's compute chiplets and on-interposer memory stacks
(HBM) on a 2.5D interposer (or organic substrate for 2D bonding), routes
the linear inter-stage pipeline connections with Manhattan wiring, checks
(1) fit, (2) routability under per-channel wire capacity, (3) a basic
timing constraint on the longest hop, then minimizes the footprint by
sweeping shelf widths.  Results feed wirelength-aware link energy/latency
back to the upper layers (§4.4 "provides feedback to the framework").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .memory import HBM3
from .perfmodel import StageOption

MAX_INTERPOSER_MM = {"2.5D": 45.0, "2D": 70.0}   # side, reticle-stitch cap
HBM_STACK_AREA_MM2 = 110.0
ROUTING_HALO = 1.12               # per-chiplet keep-out for bump field
CHANNEL_CAPACITY = 16             # parallel links per routing channel
WIRE_PJ_PER_BIT_MM = 0.10         # incremental link energy vs length
WIRE_NS_PER_MM = 0.10             # ~10 ps/mm RC-repeated wire
MAX_HOP_NS = 5.0                  # basic timing constraint per hop


@dataclasses.dataclass(frozen=True)
class Placement:
    name: str
    x: float
    y: float
    w: float
    h: float

    @property
    def center(self) -> tuple[float, float]:
        return (self.x + self.w / 2, self.y + self.h / 2)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Placement":
        return Placement(**d)


@dataclasses.dataclass
class PnrResult:
    feasible: bool
    width: float
    height: float
    area_mm2: float
    wirelength_mm: float
    max_hop_mm: float
    n_packages: int
    placements: list[Placement]
    extra_link_energy_pj_per_bit: float
    extra_hop_latency_ns: float
    reason: str = ""

    def to_dict(self) -> dict:
        # asdict deep-converts the nested Placements already
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "PnrResult":
        d = dict(d)
        d["placements"] = [Placement.from_dict(p)
                           for p in d["placements"]]
        return PnrResult(**d)


def _rects_for(stages: Sequence[StageOption]) -> list[tuple[str, float]]:
    """(name, area) rectangles for one pipeline slice: tp compute dies per
    stage plus on-interposer HBM stacks.  DDR/LPDDR/GDDR sit off-package
    (edge PHYs only)."""
    rects: list[tuple[str, float]] = []
    for i, o in enumerate(stages):
        for t in range(o.cfg.tp):
            rects.append((f"s{i}.c{t}",
                          o.cfg.chiplet.area_mm2 * ROUTING_HALO))
        if o.cfg.memory is HBM3 or o.cfg.memory.name == "HBM3":
            for u in range(o.cfg.mem_units):
                rects.append((f"s{i}.hbm{u}", HBM_STACK_AREA_MM2))
    return rects


def _shelf_pack(rects: list[tuple[str, float]],
                width: float) -> tuple[list[Placement], float, float]:
    """First-fit-decreasing shelf packing of near-square rectangles."""
    sized = sorted(((n, math.sqrt(a), math.sqrt(a)) for n, a in rects),
                   key=lambda r: -r[2])
    placements: list[Placement] = []
    x = y = shelf_h = 0.0
    used_w = 0.0
    for name, w, h in sized:
        if x + w > width and x > 0:
            y += shelf_h
            x, shelf_h = 0.0, 0.0
        placements.append(Placement(name, x, y, w, h))
        x += w
        shelf_h = max(shelf_h, h)
        used_w = max(used_w, x)
    return placements, used_w, y + shelf_h


def place_and_route(stages: Sequence[StageOption],
                    bonding: str | None = None) -> PnrResult:
    """Validate physical implementability of one pipeline slice."""
    if not stages:
        return PnrResult(True, 0, 0, 0, 0, 0, 1, [], 0.0, 0.0)
    bonding = bonding or max(o.cfg.chiplet.bonding for o in stages)
    max_side = MAX_INTERPOSER_MM[bonding]
    rects = _rects_for(stages)
    total_area = sum(a for _, a in rects)

    # One package if it can fit; otherwise split the slice across packages.
    n_packages = max(1, math.ceil(total_area / (max_side * max_side * 0.80)))
    per_pkg = rects if n_packages == 1 else \
        rects[: max(1, len(rects) // n_packages)]

    best: tuple[float, list[Placement], float, float] | None = None
    lo = math.sqrt(sum(a for _, a in per_pkg))
    for k in range(6):                         # footprint minimization sweep
        width = min(max_side, lo * (1.0 + 0.25 * k))
        placements, w, h = _shelf_pack(per_pkg, width)
        if w > max_side or h > max_side:
            continue
        bbox = w * h
        if best is None or bbox < best[0]:
            best = (bbox, placements, w, h)
    if best is None:
        return PnrResult(False, 0, 0, total_area, 0, 0, n_packages, [],
                         0.0, 0.0, reason="slice does not fit interposer")

    bbox, placements, w, h = best
    by_name = {p.name: p for p in placements}

    # Route consecutive stages (linear pipeline) with Manhattan wires.
    wirelength = 0.0
    max_hop = 0.0
    hops = 0
    for i in range(len(stages) - 1):
        a = by_name.get(f"s{i}.c0")
        b = by_name.get(f"s{i + 1}.c0")
        if a is None or b is None:
            continue
        (ax, ay), (bx, by) = a.center, b.center
        d = abs(ax - bx) + abs(ay - by)
        wirelength += d
        max_hop = max(max_hop, d)
        hops += 1
    # TP sibling links (skip stages spilled to another package)
    for i, o in enumerate(stages):
        if o.cfg.tp > 1:
            a, b = by_name.get(f"s{i}.c0"), by_name.get(f"s{i}.c1")
            if a is None or b is None:
                continue
            (ax, ay), (bx, by) = a.center, b.center
            wirelength += abs(ax - bx) + abs(ay - by)

    # Routability: wires crossing the vertical mid-cut vs channel capacity.
    mid = w / 2
    crossing = 0
    for i in range(len(stages) - 1):
        a = by_name.get(f"s{i}.c0")
        b = by_name.get(f"s{i + 1}.c0")
        if a and b and (a.center[0] - mid) * (b.center[0] - mid) < 0:
            crossing += 1
    routable = crossing <= CHANNEL_CAPACITY
    hop_ns = max_hop * WIRE_NS_PER_MM
    timing_ok = hop_ns <= MAX_HOP_NS

    feasible = routable and timing_ok
    reason = "" if feasible else \
        ("routing channel overflow" if not routable else "hop timing")
    avg_hop = wirelength / max(hops, 1)
    return PnrResult(feasible=feasible, width=w, height=h, area_mm2=bbox,
                     wirelength_mm=wirelength, max_hop_mm=max_hop,
                     n_packages=n_packages, placements=placements,
                     extra_link_energy_pj_per_bit=avg_hop * WIRE_PJ_PER_BIT_MM,
                     extra_hop_latency_ns=hop_ns, reason=reason)
