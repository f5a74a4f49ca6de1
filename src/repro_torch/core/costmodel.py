"""CATCH-style cost model (paper §4.5, [25][24][19]).

RE (recurring): wafer/lithography cost through a clustered-defect yield
model (superlinear per-die cost in area), memory, packaging/interposer,
bonding, test.  NRE (non-recurring): masks, EDA/verification, IP,
package design, software — amortized over production volume and, for
chiplets, over every *design* that reuses them (the ecosystem argument).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterable, Sequence

from .chiplets import Chiplet
from .memory import MemoryType
from .perfmodel import StageConfig, StageOption

# --- RE constants (14 nm class) --------------------------------------------
WAFER_COST_USD = 4000.0
WAFER_DIAMETER_MM = 300.0
DEFECT_DENSITY_PER_MM2 = 0.0010     # D0, mature 14 nm
YIELD_CLUSTERING_ALPHA = 2.0        # negative-binomial alpha
TEST_COST_FRACTION = 0.05

# Packaging
INTERPOSER_USD_PER_MM2 = {"2D": 0.005, "2.5D": 0.03}
BOND_COST_USD = {"2D": 0.30, "2.5D": 1.00}
ASSEMBLY_YIELD_PER_CHIPLET = 0.995

# --- NRE constants ----------------------------------------------------------
NRE_PER_CHIPLET_DESIGN = 15e6       # masks + EDA + verification + IP, 14 nm
NRE_PER_SYSTEM_DESIGN = 7e6         # package/interposer design + SW stack
NRE_MONOLITHIC_EXTRA = 1.6          # monolithic re-spins cost more per design


def die_yield(area_mm2: float) -> float:
    """Negative binomial yield: superlinear per-die cost in area [24]."""
    return (1.0 + area_mm2 * DEFECT_DENSITY_PER_MM2
            / YIELD_CLUSTERING_ALPHA) ** (-YIELD_CLUSTERING_ALPHA)


def dies_per_wafer(area_mm2: float) -> float:
    d = WAFER_DIAMETER_MM
    side = math.sqrt(area_mm2)
    return max(1.0, (math.pi * (d / 2) ** 2 / area_mm2
                     - math.pi * d / math.sqrt(2.0 * area_mm2)))


def die_cost(area_mm2: float) -> float:
    """K_die / Y_die (paper Eq. in §4.5)."""
    k_die = WAFER_COST_USD / dies_per_wafer(area_mm2)
    return k_die / die_yield(area_mm2) * (1.0 + TEST_COST_FRACTION)


@functools.lru_cache(maxsize=None)
def chiplet_re_cost(c: Chiplet) -> float:
    return die_cost(c.area_mm2) + BOND_COST_USD[c.bonding]


@functools.lru_cache(maxsize=None)
def _stage_hw_cost(chiplet: Chiplet, tp: int, memory: MemoryType,
                   units: int) -> float:
    return chiplet_re_cost(chiplet) * tp + memory.cost(units)


def stage_hw_cost(cfg: StageConfig) -> float:
    """Manufacturing cost of one stage config: tp chiplet dies + the
    stage's memory subsystem (cached per distinct config)."""
    return _stage_hw_cost(cfg.chiplet, cfg.tp, cfg.memory, cfg.mem_units)


def price_stage_options(options: Iterable[StageOption]) -> list[StageOption]:
    """Fill hw_cost_usd: tp chiplet dies + the stage's memory subsystem."""
    return [dataclasses.replace(o, hw_cost_usd=stage_hw_cost(o.cfg))
            for o in options]


@dataclasses.dataclass(frozen=True)
class SystemCost:
    die: float
    memory: float
    packaging: float
    nre_per_unit: float
    total_per_unit: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def system_cost(stages: Sequence[StageOption], *,
                volume: float = 1e6,
                n_networks_sharing: dict[str, int] | None = None,
                monolithic: bool = False) -> SystemCost:
    """Full unit-cost breakdown for a composed BASIC (Fig. 9).

    n_networks_sharing: chiplet label -> number of BASIC designs that reuse
    it.  Pool reuse divides each chiplet's design NRE by (reuse * volume);
    a bespoke/unconstrained design eats the whole NRE itself.
    """
    n_networks_sharing = n_networks_sharing or {}
    die = mem = pack = 0.0
    interposer_area = 0.0
    n_chiplets = 0
    uniq: dict[str, Chiplet] = {}
    for o in stages:
        c = o.cfg.chiplet
        n = o.cfg.tp * max(o.repeat, 1)    # physical copies of this stage
        die += die_cost(c.area_mm2) * n
        mem += o.cfg.memory.cost(o.cfg.mem_units) * max(o.repeat, 1)
        pack += BOND_COST_USD[c.bonding] * n
        interposer_area += c.area_mm2 * n * 1.3          # routing margin
        interposer_area += o.cfg.memory.phy_area_mm2 * max(o.repeat, 1)
        n_chiplets += n
        uniq[c.label] = c
    bond = max(b for b in (o.cfg.chiplet.bonding for o in stages)) \
        if stages else "2D"
    pack += interposer_area * INTERPOSER_USD_PER_MM2[bond]
    # Large slices span multiple packages; known-good-die test + package-
    # level discard bounds the compounding assembly-yield loss at the
    # per-package chiplet count (~24 sites).
    assembly_yield = ASSEMBLY_YIELD_PER_CHIPLET ** min(n_chiplets, 24)
    re = (die + mem + pack) / assembly_yield

    if monolithic:
        area = sum(o.cfg.chiplet.area_mm2 * o.cfg.tp for o in stages)
        re = die_cost(area) + mem / assembly_yield
        nre = NRE_PER_CHIPLET_DESIGN * NRE_MONOLITHIC_EXTRA \
            + NRE_PER_SYSTEM_DESIGN
        nre_unit = nre / volume
    else:
        nre = NRE_PER_SYSTEM_DESIGN
        nre_unit = nre / volume
        for label, c in uniq.items():
            reuse = max(1, n_networks_sharing.get(label, 1))
            nre_unit += NRE_PER_CHIPLET_DESIGN / (reuse * volume)

    return SystemCost(die=die, memory=mem, packaging=pack,
                      nre_per_unit=nre_unit,
                      total_per_unit=re + nre_unit)
