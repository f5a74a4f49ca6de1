"""Tile plan of the bfloat16 flash attention kernel (`flash_tc_kernel` in
`csrc/flash_attention.cu`).

`flash_plan(b, h, hkv, sq, hd)` picks how a call is cut into blocks:

* A block serves one query head and `warps` warps of 16 positions each:
  8 where blocks of 8 still give at least half the SMs of the card one
  (each staged K/V tile then serves 128 query rows, and hd-128 blocks of
  4, two of which do not fit one SM's shared memory, would leave a
  second wave), else 4.
* The grid is (B * H, ceil(Sq / bq)); blockIdx.y counts the query tiles
  from the last down, so under a causal mask the heaviest tiles are
  launched first (`block_order`).

`tile_class` and `kv_range` mirror the kernel's functions of the same
names: which key tiles of 64 a query tile walks, and whether a tile is
skipped (no valid pair), full (no masked pair: no mask applied) or an
edge (the mask applied element by element).  The kernel computes them
itself; the CPU tests hold these copies against a brute-force mask.
"""
from __future__ import annotations

from dataclasses import dataclass

BK = 64                   # keys a K/V tile (kTcBK)
STAGES = 3                # K/V ring stages (kTcStages)
MAX_WARPS = 8             # warps a block at most (kTcMaxWarps)
SMS = 132                 # streaming multiprocessors of an H100 SXM
HEAD_DIMS = (32, 64, 80, 128)

SKIP, FULL, EDGE = 0, 1, 2


@dataclass(frozen=True)
class FlashPlan:
    warps: int            # warps a block, 16 query positions each
    bq: int               # query positions a block
    grid: tuple[int, int] # (B * H, query tiles)
    smem_bytes: int       # dynamic shared memory a block

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(hd: int, warps: int) -> int:
    """Q rows of the warps and the K/V ring, rows padded by 8 values
    (`tc_smem_bytes`)."""
    return (warps * 16 + STAGES * 2 * BK) * (hd + 8) * 2


def flash_plan(b: int, h: int, hkv: int, sq: int, hd: int, *,
               sms: int = SMS) -> FlashPlan:
    """The plan of a call on a card with `sms` SMs."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: H {h} is not a multiple of Hkv {hkv}")
    warps = MAX_WARPS if 2 * b * h * _cdiv(sq, 16 * MAX_WARPS) >= sms else 4
    return FlashPlan(warps=warps, bq=16 * warps,
                     grid=(b * h, _cdiv(sq, 16 * warps)),
                     smem_bytes=smem_bytes(hd, warps))


def block_order(plan: FlashPlan, h: int):
    """(b, head, first query position) of each block in launch order (x
    fastest, then y), as the kernel decodes blockIdx."""
    for y in range(plan.grid[1]):
        qt = plan.grid[1] - 1 - y
        for x in range(plan.grid[0]):
            yield x // h, x % h, qt * plan.bq


def tile_class(q0: int, bq: int, k0: int, bk: int, sq: int, sk: int,
               causal: bool, window: int | None) -> int:
    """SKIP, FULL or EDGE for query rows [q0, q0 + bq) and keys [k0, k0 +
    bk); rows >= sq are padding and ignored."""
    w = window or 0
    q_hi = min(q0 + bq, sq) - 1
    k_hi = min(k0 + bk, sk) - 1
    if q_hi < q0 or k_hi < k0:
        return SKIP
    # the keys valid for some row of [q0, q_hi] form [q0 - w + 1, q_hi]
    if causal and k0 > q_hi:
        return SKIP
    if w > 0 and k_hi <= q0 - w:
        return SKIP
    full = (k0 + bk <= sk and (not causal or k0 + bk - 1 <= q0)
            and (w <= 0 or k0 > q_hi - w))
    return FULL if full else EDGE


def kv_range(q0: int, bq: int, sq: int, sk: int, causal: bool,
             window: int | None, bk: int = BK) -> tuple[int, int]:
    """(first, last) key tile a query tile walks; last < first: none."""
    w = window or 0
    q_hi = min(q0 + bq, sq) - 1
    k_hi = min(sk - 1, q_hi) if causal else sk - 1
    k_lo = max(0, q0 - w + 1) if w > 0 else 0
    first = k_lo // bk
    last = first - 1 if q_hi < q0 or k_hi < k_lo else k_hi // bk
    return first, last
