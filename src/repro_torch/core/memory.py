"""Memory pool (paper §2: DDR5, LPDDR5, GDDR7, HBM3E).

Per-unit figures are one stack (HBM), one device (GDDR/LPDDR) or one
channel (DDR5).  $ figures follow the paper's sources [50][59][60][30]
to first order; what matters for reproducing Fig. 2 is the *ordering*
(HBM >> GDDR > LPDDR > DDR in both bandwidth and $/GB).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, order=True)
class MemoryType:
    name: str
    bw_per_unit: float       # bytes/s
    capacity_per_unit: float # bytes
    pj_per_bit: float        # access energy
    usd_per_gb: float
    phy_cost_usd: float      # controller+PHY per unit
    phy_area_mm2: float      # beachfront consumed on the host die

    def units_for(self, capacity_bytes: float, bandwidth_bps: float) -> int:
        by_cap = -(-int(capacity_bytes) // int(self.capacity_per_unit))
        by_bw = -(-int(bandwidth_bps) // int(self.bw_per_unit))
        return max(1, by_cap, by_bw)

    def cost(self, units: int) -> float:
        gb = units * self.capacity_per_unit / 1e9
        return gb * self.usd_per_gb + units * self.phy_cost_usd

    def energy_j(self, bytes_moved: float) -> float:
        return bytes_moved * 8.0 * self.pj_per_bit * 1e-12

    def to_dict(self) -> dict:
        """JSON form.  Stock pool members serialize as their name only;
        custom memory types carry their full parameterization."""
        stock = MEMORY_BY_NAME.get(self.name)
        if stock == self:
            return {"name": self.name}
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "MemoryType":
        if set(d) == {"name"}:
            return MEMORY_BY_NAME[d["name"]]
        return MemoryType(**d)


HBM3 = MemoryType("HBM3", bw_per_unit=819e9, capacity_per_unit=24e9,
                  pj_per_bit=3.9, usd_per_gb=15.0, phy_cost_usd=40.0,
                  phy_area_mm2=12.0)
GDDR7 = MemoryType("GDDR7", bw_per_unit=128e9, capacity_per_unit=2e9,
                   pj_per_bit=7.0, usd_per_gb=8.0, phy_cost_usd=8.0,
                   phy_area_mm2=4.0)
LPDDR5 = MemoryType("LPDDR5", bw_per_unit=51.2e9, capacity_per_unit=8e9,
                    pj_per_bit=4.5, usd_per_gb=4.0, phy_cost_usd=5.0,
                    phy_area_mm2=3.0)
DDR5 = MemoryType("DDR5", bw_per_unit=38.4e9, capacity_per_unit=16e9,
                  pj_per_bit=12.0, usd_per_gb=3.0, phy_cost_usd=4.0,
                  phy_area_mm2=3.0)

MEMORY_POOL: tuple[MemoryType, ...] = (HBM3, GDDR7, LPDDR5, DDR5)
MEMORY_BY_NAME = {m.name: m for m in MEMORY_POOL}
