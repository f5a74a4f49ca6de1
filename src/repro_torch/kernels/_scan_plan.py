"""Tile plan of the RG-LRU scan kernels (`csrc/rglru_scan.cu`).

`scan_plan(b, s, w, elem_bytes)` cuts a call h_t = a_t * h_{t-1} + b_t
over (B, S, W) into blocks, from the shapes and the SM count alone:

* S = 1 (decode) takes the step route: one thread a (batch, vector of
  channels), no time loop.
* Otherwise the cluster route.  A block owns a tile of 32 channels of
  one batch row (one 128-byte line a warp row in float32) and, in each
  round, a span of `tile` = 8 warps x `chunk` time steps, a warp a
  contiguous chunk.  The blocks of a thread-block cluster (`cluster` of
  them, 1, 2, 4 or 8) take consecutive spans: a round of a cluster
  covers cluster x tile steps, and a cluster walks `rounds` of them,
  carrying h from one round to the next.
* The cluster grows (doubling) while the card has fewer than two blocks
  an SM and each warp of the grown cluster still gets at least
  `MIN_STEPS` steps of the sequence; at B 1, W 2560, S 256 that is 4
  blocks a cluster, 320 blocks.  The chunk is then the fewest steps a
  warp that cover S in one round, at most `MAX_CHUNK`.

`scan_order(plan, s)` lists, for one channel tile, the time steps each
(round, block, warp) walks: the order the kernel chains the warps'
carries in (rank-major within a round), which the CPU tests emulate.
"""
from __future__ import annotations

from dataclasses import dataclass

LANES = 32                # channels a block (kLanes)
WARPS = 8                 # warps a block (kWarps)
MAX_CHUNK = 32            # time steps a warp a round, at most (kMaxChunk)
MAX_CLUSTER = 8           # blocks a cluster, at most (the portable limit)
MIN_STEPS = 4             # steps a warp keeps at least when the cluster grows
STEP_THREADS = 256        # threads a block of the step route (kStepThreads)
SMS = 132                 # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232448         # dynamic shared memory a block can opt in to


@dataclass(frozen=True)
class ScanPlan:
    route: str            # "step" (S = 1) or "cluster"
    cluster: int          # blocks a cluster (1 on the step route)
    chunk: int            # time steps a warp a round
    rounds: int           # rounds a cluster walks
    blocks: int           # blocks of the launch
    smem_bytes: int       # dynamic shared memory a block

    @property
    def tile(self) -> int:
        """Time steps a block a round."""
        return WARPS * self.chunk


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(chunk: int, cluster: int, elem_bytes: int) -> int:
    """a and b of one round's tile and every warp's (A, H) summary of the
    cluster (`smem_bytes` in the kernel)."""
    return 2 * WARPS * chunk * LANES * elem_bytes + 2 * 4 * cluster * WARPS * LANES


def scan_plan(b: int, s: int, w: int, elem_bytes: int = 4, *,
              sms: int = SMS, max_cluster: int = MAX_CLUSTER) -> ScanPlan:
    """The plan of a call on a card with `sms` SMs; `max_cluster` caps
    the cluster (the launch lowers it where the card holds no cluster of
    the planned size)."""
    if min(b, s, w) < 1:
        raise ValueError(f"rglru_scan: empty shape B={b} S={s} W={w}")
    if elem_bytes not in (2, 4):
        raise ValueError(f"rglru_scan: {elem_bytes}-byte elements")
    if s == 1:
        vec = 16 // elem_bytes
        return ScanPlan(route="step", cluster=1, chunk=1, rounds=1,
                        blocks=b * _cdiv(w, STEP_THREADS * vec), smem_bytes=0)
    tiles = b * _cdiv(w, LANES)
    cs = 1
    while (2 * cs <= max_cluster and tiles * cs < 2 * sms
           and s >= 2 * cs * WARPS * MIN_STEPS):
        cs *= 2
    chunk = min(MAX_CHUNK, _cdiv(s, cs * WARPS))
    blocks = tiles * cs
    if blocks > 2 ** 31 - 1:
        raise ValueError("rglru_scan: grid limits exceeded")
    return ScanPlan(route="cluster", cluster=cs, chunk=chunk,
                    rounds=_cdiv(s, cs * WARPS * chunk), blocks=blocks,
                    smem_bytes=smem_bytes(chunk, cs, elem_bytes))


def scan_order(plan: ScanPlan, s: int):
    """For one channel tile, in the order the kernel chains the carries:
    per round, per block rank, per warp, the range of time steps that
    warp walks (empty past S)."""
    out = []
    for r in range(plan.rounds):
        ranks = []
        for rank in range(plan.cluster):
            t0 = (r * plan.cluster + rank) * plan.tile
            ranks.append([range(min(s, t0 + k * plan.chunk),
                                min(s, t0 + (k + 1) * plan.chunk))
                          for k in range(WARPS)])
        out.append(ranks)
    return out
