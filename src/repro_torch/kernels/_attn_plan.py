"""Tile plan of the bfloat16 flash attention kernel (`flash_tc_kernel` in
`csrc/flash_attention.cu`).

`flash_plan(b, h, hkv, sq, hd)` picks how a call is cut into blocks:

* The K/V ring has 3 stages where a block of 8 warps fits one SM's
  shared memory with them, else 2 (hd 256); the kernel reads the count.

* A block serves one query head and `warps` warps of 16 positions each:
  8 where blocks of 8 still give at least half the SMs of the card one
  (each staged K/V tile then serves 128 query rows, and hd-128 blocks of
  4, two of which do not fit one SM's shared memory, would leave a
  second wave), else 4.
* The grid is (B * H, ceil(Sq / bq)); blockIdx.y counts the query tiles
  from the last down, so under a causal mask the heaviest tiles are
  launched first (`block_order`).

Past hd 256 every type takes the column-split kernel
(`flash_wide_kernel`): `flash_column_blocks(hd)` blocks of 256 output
columns, each recomputing the full-hd scores (no padding, no tile plan).

`tile_class` and `kv_range` mirror the kernel's functions of the same
names: which key tiles of 64 a query tile walks, and whether a tile is
skipped (no valid pair), full (no masked pair: no mask applied) or an
edge (the mask applied element by element).  The kernel computes them
itself; the CPU tests hold these copies against a brute-force mask.

`paged_plan(b, h, hkv, npp, ps, hd, elem_bytes)` cuts a paged decode call
(`csrc/paged_decode.cu`) into blocks of one (slot, kv head, head chunk,
split), a split being a fixed run of whole pages.  It reads shapes and
the SM count, never the lengths, so the grid is the same for any lengths
(no host read, no sync).  Past hd 1024 the output columns are cut into
blocks of 1024 (`col_blocks`, a third grid dimension), each recomputing
the full-hd scores.
"""
from __future__ import annotations

from dataclasses import dataclass

BK = 64                   # keys a K/V tile (kTcBK)
STAGES = 3                # K/V ring stages where they fit (kTcStages)
MAX_WARPS = 8             # warps a block at most (kTcMaxWarps)
SMS = 132                 # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232448         # dynamic shared memory a block can opt in to
# the head dims the kernels are built for; any other hd up to the last is
# zero-padded to the next of them (`padded_head_dim`); wider heads take
# the column-split kernel at their own width
HEAD_DIMS = (32, 64, 80, 96, 128, 160, 192, 256)
WIDE_COLS = 256           # output columns a block of the column split (kWideCols)
WIDE_ROWS = 8             # query rows a block of the column split (kWideRows)

SKIP, FULL, EDGE = 0, 1, 2


@dataclass(frozen=True)
class FlashPlan:
    warps: int            # warps a block, 16 query positions each
    bq: int               # query positions a block
    grid: tuple[int, int] # (B * H, query tiles)
    smem_bytes: int       # dynamic shared memory a block
    stages: int = STAGES  # K/V ring stages

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(hd: int, warps: int, stages: int = STAGES) -> int:
    """Q rows of the warps and the K/V ring, rows padded by 8 values
    (`tc_smem_bytes`)."""
    return (warps * 16 + stages * 2 * BK) * (hd + 8) * 2


def tc_stages(hd: int) -> int:
    """Ring stages of the head dim's kernel: 3 where a block of the most
    warps fits, else 2 (hd 256: 3 stages would take 270,336 bytes)
    (`tc_stages`)."""
    return STAGES if smem_bytes(hd, MAX_WARPS, STAGES) <= SMEM_MAX else 2


def padded_head_dim(hd: int) -> int:
    """The head dim a call runs at: the least of `HEAD_DIMS` >= hd; hd
    itself past the last (the column split takes any width)."""
    for k in HEAD_DIMS:
        if k >= hd:
            return k
    return hd


def flash_column_blocks(hd: int) -> int:
    """Blocks of `WIDE_COLS` output columns of the column split (hd > 256;
    1 otherwise: the tile kernels hold all of hd)."""
    return _cdiv(hd, WIDE_COLS) if hd > HEAD_DIMS[-1] else 1


def flash_plan(b: int, h: int, hkv: int, sq: int, hd: int, *,
               sms: int = SMS) -> FlashPlan:
    """The plan of a call on a card with `sms` SMs (hd one of
    `HEAD_DIMS`)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: H {h} is not a multiple of Hkv {hkv}")
    warps = MAX_WARPS if 2 * b * h * _cdiv(sq, 16 * MAX_WARPS) >= sms else 4
    stages = tc_stages(hd)
    return FlashPlan(warps=warps, bq=16 * warps,
                     grid=(b * h, _cdiv(sq, 16 * warps)),
                     smem_bytes=smem_bytes(hd, warps, stages), stages=stages)


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


# -- paged decode (csrc/paged_decode.cu) ----------------------------------------

PAGED_MAX_PAGES = 64      # pages a split, at most (kMaxPages)
PAGED_COL_BLOCK = 1024    # output columns a block: 32 lanes x 4 chunks of 8 (kColBlock)
PAGED_MAX_HD = 4096       # widest head: blocks of 1024 columns past 1024 (kMaxHd)
PAGED_MAX_SPLITS = 4096   # the combine kernel's weights in shared memory
# "tc": bfloat16 or float16, hd in 32..128 in steps of 16, rows on 16-byte steps
# (paged_tc_kernel, one warp a block, up to 16 query heads as the rows of
# mma.m16n8k16, tiles of 32 positions in a 3-stage ring); "fma": the rest
# (paged_split_kernel, 4 warps, up to 8 query heads -- 1 above hd 256 --,
# 8-value chunks of hd a lane, the last one masked past hd)
TC_ROWS, TC_MAX_HEADS = 32, 16
FMA_THREADS, FMA_MAX_HEADS = 128, 8


@dataclass(frozen=True)
class PagedPlan:
    route: str            # "tc" or "fma"
    rows: int             # positions a tile (one stage of the K/V ring)
    heads: int            # query heads a block, at most
    head_chunks: int      # blocks that share one kv head's query heads
    pages: int            # pages a split
    splits: int           # splits a (slot, kv head)
    grid: tuple[int, int] # (B * Hkv * head_chunks, splits)
    col_blocks: int = 1   # blocks of PAGED_COL_BLOCK output columns (grid z)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.col_blocks

    def workspace_floats(self, b: int, h: int, hd: int) -> int:
        """Float32 partials (m, l, acc[hd]) of every (slot, query head,
        split); none with one split (the blocks write the output)."""
        return 0 if self.splits == 1 else b * h * self.splits * (hd + 2)


def tc_route(hd: int, elem_bytes: int, aligned: bool = True) -> bool:
    return aligned and elem_bytes == 2 and hd % 16 == 0 and 32 <= hd <= 128


def paged_plan(b: int, h: int, hkv: int, npp: int, ps: int, hd: int,
               elem_bytes: int, *, sms: int = SMS,
               aligned: bool = True) -> PagedPlan:
    """The plan of a paged decode call on a card with `sms` SMs;
    `aligned`: the pools' rows and strides are on 16-byte steps.

    * Route and tile: "tc" tiles are 32 positions; in "fma" blocks a
      position's hd values are read in 8-value chunks by the next power
      of two >= hd / 8 lanes (at least 4, at most 32, a lane holding up
      to 4 chunks above hd 256), 128 / lanes positions a pass, two
      passes a tile in a 16-bit type and one in float32 or past hd 1024.
    * Columns: past hd 1024, `col_blocks` blocks of 1024 output columns,
      each recomputing the full-hd scores (two ring stages, whole K rows
      and the block's V columns in shared memory).
    * Heads: a block serves up to 16 ("tc") or 8 ("fma"; 1 above hd 256)
      query heads of one kv head; a larger group is cut into equal head
      chunks.
    * Pages a split: the fewest that give the card about eight blocks an
      SM ("tc", one warp each) or two ("fma", four warps each), at least
      one tile's worth and at most 64; splits = ceil(npp / pages).
    """
    if not 1 <= hd <= PAGED_MAX_HD:
        raise ValueError(f"paged_decode_attention: head dim {hd} must be in "
                         f"1..{PAGED_MAX_HD}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"paged_decode_attention: H {h} is not a multiple "
                         f"of Hkv {hkv}")
    if elem_bytes not in (2, 4):
        raise ValueError(f"paged_decode_attention: {elem_bytes}-byte elements")
    if b < 1 or ps < 1 or npp < 1:
        raise ValueError("paged_decode_attention: B, the page size and the "
                         "pages a slot must be >= 1")
    group = h // hkv
    if tc_route(hd, elem_bytes, aligned):
        route, rows, max_heads = "tc", TC_ROWS, TC_MAX_HEADS
        per_sm = 8
    else:
        lanes = min(32, max(4, _pow2_at_least(_cdiv(hd, 8))))
        route, max_heads = "fma", FMA_MAX_HEADS if hd <= 256 else 1
        rows = FMA_THREADS // lanes * (2 if elem_bytes == 2 and hd <= PAGED_COL_BLOCK
                                       else 1)
        per_sm = 2
    head_chunks = _cdiv(group, max_heads)
    heads = _cdiv(group, head_chunks)
    base = b * hkv * head_chunks
    pages = max(_cdiv(rows, ps), _cdiv(npp, _cdiv(per_sm * sms, base)))
    pages = min(PAGED_MAX_PAGES, pages)
    splits = _cdiv(npp, pages)
    if splits > PAGED_MAX_SPLITS:
        raise ValueError(f"paged_decode_attention: {npp} pages a slot need "
                         f"more than {PAGED_MAX_SPLITS} splits")
    col_blocks = _cdiv(hd, PAGED_COL_BLOCK) if hd > PAGED_COL_BLOCK else 1
    return PagedPlan(route=route, rows=rows, heads=heads,
                     head_chunks=head_chunks, pages=pages, splits=splits,
                     grid=(base, splits), col_blocks=col_blocks)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())
