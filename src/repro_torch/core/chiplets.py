"""Chiplet design space (paper Table 4).

A chiplet is a compute die: a PE array with a given dataflow
(Row/Weight/Output-Stationary), a global buffer (GLB), and a bonding
technology.  Constants are first-order 14 nm figures in the
Eyeriss [12] / Simba [51] lineage — this module plays the role the
Timeloop architecture description plays in the paper.
"""
from __future__ import annotations

import dataclasses
import itertools

DATAFLOWS = ("RS", "OS", "WS")
PE_SCALES = (1, 2, 3, 4)          # PE array dim = 64 * 2**(scale-1): 64..512
GLB_SCALES = (1, 4, 9, 16)        # GLB bytes = 512 KiB * scale
BONDINGS = ("2D", "2.5D")

CLOCK_HZ = 1e9                    # 1 GHz (Table 4)
BASE_PE_DIM = 64
BASE_GLB_BYTES = 512 * 1024

# Area model (mm^2, 14 nm): a 64x64 MAC array w/ register files ~= 3 mm^2,
# scaling ~quadratically with array dim; SRAM ~= 1 MiB / mm^2.
PE_AREA_BASE_MM2 = 3.0
SRAM_MM2_PER_MIB = 1.0
PERIPHERY_MM2 = 1.5               # NoC, controller, PHY beachfront

# Power model. Leakage density chosen so static power lands near the
# paper's "up to 30% of total power" observation (§4.3.1, [20]).
LEAKAGE_W_PER_MM2 = 0.025

# Energy per 16-bit MAC (J) before dataflow adjustment; 14 nm class.
E_MAC_BASE = 0.4e-12
# GLB SRAM access energy per byte.
E_SRAM_BYTE = 0.8e-12
# Inter-chiplet link energy (Simba [51], Table 4): 1.3 pJ/bit.
E_INTERCHIP_BIT = 1.3e-12
# Inter-chiplet bandwidth per link (2D organic vs 2.5D interposer).
INTERCHIP_GBPS = {"2D": 64e9, "2.5D": 512e9}   # bytes/s

# Dataflow -> operator-kind compute utilization (fraction of peak MACs).
# This is the Timeloop mapping-quality stand-in: each dataflow favors the
# reuse pattern it keeps stationary (Insight 4).
UTILIZATION = {
    ("WS", "gemm"): 0.90, ("WS", "conv"): 0.72, ("WS", "dwconv"): 0.28,
    ("WS", "attention"): 0.45, ("WS", "elementwise"): 0.04,
    ("WS", "norm"): 0.04, ("WS", "scan"): 0.08, ("WS", "embed"): 0.30,
    ("OS", "gemm"): 0.80, ("OS", "conv"): 0.70, ("OS", "dwconv"): 0.38,
    ("OS", "attention"): 0.85, ("OS", "elementwise"): 0.10,
    ("OS", "norm"): 0.10, ("OS", "scan"): 0.15, ("OS", "embed"): 0.30,
    ("RS", "gemm"): 0.70, ("RS", "conv"): 0.90, ("RS", "dwconv"): 0.55,
    ("RS", "attention"): 0.60, ("RS", "elementwise"): 0.08,
    ("RS", "norm"): 0.08, ("RS", "scan"): 0.12, ("RS", "embed"): 0.30,
}

# Dataflow -> operator-kind SRAM traffic multiplier (x operand bytes); a
# well-matched dataflow re-reads operands from GLB fewer times.
SRAM_TRAFFIC = {
    ("WS", "gemm"): 1.5, ("WS", "conv"): 2.5, ("WS", "dwconv"): 3.0,
    ("WS", "attention"): 3.5, ("WS", "elementwise"): 1.0,
    ("WS", "norm"): 1.0, ("WS", "scan"): 2.0, ("WS", "embed"): 1.0,
    ("OS", "gemm"): 2.0, ("OS", "conv"): 2.5, ("OS", "dwconv"): 2.2,
    ("OS", "attention"): 1.6, ("OS", "elementwise"): 1.0,
    ("OS", "norm"): 1.0, ("OS", "scan"): 1.5, ("OS", "embed"): 1.0,
    ("RS", "gemm"): 2.2, ("RS", "conv"): 1.5, ("RS", "dwconv"): 1.6,
    ("RS", "attention"): 2.5, ("RS", "elementwise"): 1.0,
    ("RS", "norm"): 1.0, ("RS", "scan"): 1.8, ("RS", "embed"): 1.0,
}


@dataclasses.dataclass(frozen=True, order=True)
class Chiplet:
    dataflow: str = "WS"
    pe_scale: int = 1
    glb_scale: int = 1
    bonding: str = "2.5D"

    def __post_init__(self):
        assert self.dataflow in DATAFLOWS
        assert self.pe_scale in PE_SCALES
        assert self.glb_scale in GLB_SCALES
        assert self.bonding in BONDINGS

    def __hash__(self):
        # Chiplets key every evaluation-engine cache; memoize the hash
        # (frozen -> fields never change).
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.dataflow, self.pe_scale, self.glb_scale,
                      self.bonding))
            object.__setattr__(self, "_hash", h)
        return h

    @property
    def pe_dim(self) -> int:
        return BASE_PE_DIM * 2 ** (self.pe_scale - 1)

    @property
    def n_pes(self) -> int:
        return self.pe_dim * self.pe_dim

    @property
    def peak_flops(self) -> float:
        return 2.0 * self.n_pes * CLOCK_HZ        # MAC = 2 FLOPs

    @property
    def glb_bytes(self) -> int:
        return BASE_GLB_BYTES * self.glb_scale

    @property
    def area_mm2(self) -> float:
        pe = PE_AREA_BASE_MM2 * (self.pe_dim / BASE_PE_DIM) ** 2
        glb = SRAM_MM2_PER_MIB * self.glb_bytes / (1 << 20)
        return pe + glb + PERIPHERY_MM2

    @property
    def static_power_w(self) -> float:
        return LEAKAGE_W_PER_MM2 * self.area_mm2

    @property
    def interchip_bw(self) -> float:
        return INTERCHIP_GBPS[self.bonding]

    def utilization(self, kind: str) -> float:
        return UTILIZATION[(self.dataflow, kind)]

    def sram_traffic_factor(self, kind: str) -> float:
        return SRAM_TRAFFIC[(self.dataflow, kind)]

    @property
    def label(self) -> str:
        return (f"{self.dataflow}-pe{self.pe_dim}"
                f"-glb{self.glb_bytes // 1024}K-{self.bonding}")

    def to_dict(self) -> dict:
        return {"dataflow": self.dataflow, "pe_scale": self.pe_scale,
                "glb_scale": self.glb_scale, "bonding": self.bonding}

    @staticmethod
    def from_dict(d: dict) -> "Chiplet":
        return Chiplet(dataflow=d["dataflow"], pe_scale=d["pe_scale"],
                       glb_scale=d["glb_scale"], bonding=d["bonding"])


def full_design_space() -> list[Chiplet]:
    """All 96 chiplet configurations (3 dataflows x 4 PE x 4 GLB x 2 bond)."""
    return [Chiplet(d, p, g, b)
            for d, p, g, b in itertools.product(DATAFLOWS, PE_SCALES,
                                                GLB_SCALES, BONDINGS)]


def default_pool() -> list[Chiplet]:
    """A reasonable 8-chiplet starting pool covering the operator classes
    (Mozart's SA search refines from here)."""
    return [
        Chiplet("WS", 4, 9, "2.5D"),    # big-batch GEMM (prefill projections)
        Chiplet("WS", 2, 4, "2.5D"),    # mid GEMM
        Chiplet("OS", 3, 4, "2.5D"),    # attention / reductions
        Chiplet("OS", 1, 1, "2D"),      # small attention / decode
        Chiplet("RS", 3, 9, "2.5D"),    # large conv
        Chiplet("RS", 1, 4, "2D"),      # depthwise / small conv
        Chiplet("WS", 1, 1, "2D"),      # GEMV / decode projections
        Chiplet("OS", 2, 16, "2.5D"),   # fused groups needing big GLB
    ]
