"""Tile plan of the gated-MLP kernels (`csrc/mlp_tile.cuh`), shared by the
`fused_mlp` and `moe_mlp` launch wrappers.

`mlp_plan(e, n, d, f, dtype)` picks, for x (E, n, d) and weights (E, d, F),
the route a call takes and its geometry:

* bfloat16 and float16 take the cluster tile: a cluster of `cl` blocks
  (8, or 16 where d > 1024) walks the ff axis of one item (one token tile
  of `nt` rows of one expert) in chunks of `cl * 64` hidden units.  A
  block's output columns set its register tile, so d's output columns
  are cut into `groups` of at most 6144 (`gcols` each), one launch a
  group, each walking the ff axis again (recomputing h: wi and wg are
  read once more a group).  `clusters`
  clusters run: at least 8 where there is the work, at most as many as
  the card holds at once (`capacity`, from the CUDA occupancy query).
  Each takes whole items in turn (`rounds` of them, written straight to
  the output); the items left over are cut into `parts` chunk ranges
  dealt to the clusters, each writing a float32 (min(nt, n), d) partial
  that a small pass sums in part order.  With one cluster an item and room for
  all of them nothing is left over and nothing is allocated.  d and F
  must be multiples of 8: `padded_call` zero-pads other widths to the
  next multiple (`tile_widths`), as the JAX kernels pad F themselves.
* float32 takes the FMA tile: ff chunks of `fc` hidden units a block, each
  writing a float32 partial of all n * d outputs.

The numbers mirror `tc_plan` in `mlp_tile.cuh`, which checks them again.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch.nn.functional as F

HB = 64                    # hidden units a block a chunk (kTcHB)
BOX = 64                   # columns of one TMA box (kTcBox)
PAD = 8                    # bf16 values of row padding of h (kTcPad)
SMEM_MAX = 232192          # dynamic shared memory a block (kTcSmemMax)
MAX_STAGES = 8             # ring stages at most (kTcMaxStages)
TOKEN_TILES = (8, 16, 32, 64, 96, 128)
# largest token tile for m16 tiles a warp in the down projection: the
# float32 sums of both projections stay in registers
MAX_TILE = {1: 128, 2: 96, 3: 64}
MIN_CLUSTERS = 8           # fewer items: cut them into chunk ranges
MAX_COLS = 6144            # output columns a launch (kTcMaxCols)
HALF_DTYPES = ("bfloat16", "float16")   # the cluster tile's types


@dataclass(frozen=True)
class MlpPlan:
    route: str             # "cluster" (bfloat16, float16) or "fma" (float32)
    blocks: int            # blocks of the main kernel
    workspace_bytes: int   # float32 partial the wrapper allocates
    fc: int = 0            # fma: hidden units a block
    cl: int = 0            # cluster: blocks a cluster
    nt: int = 0            # cluster: tokens a tile
    tiles: int = 0         # cluster: token tiles an expert
    chunks: int = 0        # cluster: ff chunks of cl * 64 hidden units
    clusters: int = 0      # cluster: clusters launched
    rounds: int = 0        # cluster: whole items a cluster
    leftover: int = 0      # cluster: items cut into parts
    parts: int = 0         # cluster: parts a leftover item
    mw: int = 0            # cluster: m16 output tiles a warp
    bk: int = 0            # cluster: d rows of one up-projection step
    stages: int = 0        # cluster: ring stages
    smem_bytes: int = 0    # cluster: dynamic shared memory a block
    groups: int = 1        # cluster: column groups of d (launches)
    gcols: int = 0         # cluster: output columns a group


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def mlp_plan(e: int, n: int, d: int, f: int, dtype: str, *,
             swiglu: bool = True, capacity: int | None = None) -> MlpPlan:
    """The route and geometry of one call (`dtype` "bfloat16", "float16"
    or "float32"); raises ValueError for a shape the route does not take.
    `capacity`: clusters the card holds at once (None: no limit)."""
    if min(e, n, d, f) < 1:
        raise ValueError(f"mlp: empty shape e={e} n={n} d={d} f={f}")
    if dtype == "float32":
        fc = 32 if e == 1 and n <= 64 else 128
        chunks = _cdiv(f, fc)
        if chunks > 65535 or e > 65535:
            raise ValueError("mlp: grid limits exceeded")
        return MlpPlan(route="fma", fc=fc, blocks=_cdiv(n, 16) * chunks * e,
                       workspace_bytes=4 * e * chunks * n * d)
    if dtype not in HALF_DTYPES:
        raise ValueError(f"mlp: dtype {dtype} not supported")
    if d % 8 or f % 8:
        raise ValueError(f"mlp: the {dtype} tile needs d and F multiples of "
                         f"8 (16-byte rows), got d={d}, F={f}")
    cl = 8 if d <= 1024 else 16
    groups = _cdiv(d, MAX_COLS)
    gcols = d if groups == 1 else _cdiv(_cdiv(d, groups), BOX) * BOX
    cpb = _cdiv(_cdiv(gcols, cl), BOX) * BOX       # output columns a block
    mw = _cdiv(cpb // 16, 8)
    assert mw in MAX_TILE, (d, gcols, mw)
    nt = next(t for t in TOKEN_TILES if t >= min(n, MAX_TILE[mw]))
    tiles = _cdiv(n, nt)
    chunks = _cdiv(f, cl * HB)
    items = e * tiles
    clusters = min(max(items, MIN_CLUSTERS), items * chunks)
    if capacity is not None:
        clusters = min(clusters, max(1, capacity))
    if clusters * cl > 2 ** 31 - 1:
        raise ValueError("mlp: grid limits exceeded")
    rounds = items // clusters
    leftover = items - rounds * clusters
    parts = min(clusters, chunks) if leftover else 0
    bk = 128 if nt <= 32 else 64
    up = (bk // BOX) * nt * 128 + (2 if swiglu else 1) * bk * 128
    stage = _cdiv(max(up, (cpb // BOX) * HB * 128), 1024) * 1024
    hbytes = 3 * nt * (HB + PAD) * 2 + 4096
    stages = min(MAX_STAGES, (SMEM_MAX - 1024 - hbytes) // stage)
    if stages < 3:
        raise ValueError(f"mlp: d={d} leaves shared memory for {stages} "
                         f"stages (3 needed)")
    return MlpPlan(route="cluster", cl=cl, nt=nt, tiles=tiles, chunks=chunks,
                   clusters=clusters, rounds=rounds, leftover=leftover,
                   parts=parts, mw=mw, bk=bk, stages=stages,
                   smem_bytes=1024 + stages * stage + hbytes,
                   blocks=cl * clusters, groups=groups, gcols=gcols,
                   workspace_bytes=4 * leftover * parts * min(nt, n) * d)


def cluster_segments(plan: MlpPlan, k: int) -> list[tuple[int, int, int, int]]:
    """The segments cluster k walks, in order, as (item, first chunk,
    chunks, part) with part -1 for a whole item: `tc_seg` / `tc_nseg` of
    `mlp_tile.cuh`."""
    segs = [(k + r * plan.clusters, 0, plan.chunks, -1)
            for r in range(plan.rounds)]
    for g in range(k, plan.leftover * plan.parts, plan.clusters):
        q = g % plan.parts
        b, e = q * plan.chunks // plan.parts, (q + 1) * plan.chunks // plan.parts
        segs.append((plan.rounds * plan.clusters + g // plan.parts, b, e - b, g))
    return segs


@functools.lru_cache(maxsize=256)
def cluster_capacity(lib: str, e: int, n: int, d: int, f: int,
                     swiglu: bool) -> int:
    """Clusters of the cluster tile's kernel for these shapes that the
    card holds at once: `<lib>_max_clusters` of `csrc/<lib>.cu` (the CUDA
    occupancy query of the bfloat16 kernel, whose block the float16 one
    shares), built at first use."""
    from repro_torch.kernels import _build

    base = mlp_plan(e, n, d, f, "bfloat16", swiglu=swiglu)
    fn = getattr(_build.library(lib), f"{lib}_max_clusters")
    fn.argtypes = [_build.INT] * 7
    fn.restype = _build.INT
    got = fn(e, n, d, f, int(swiglu), base.cl, base.nt)
    if got < 0:
        msg = getattr(_build.library(lib), f"{lib}_error_string")(-got)
        raise RuntimeError(f"{lib}: cluster occupancy query failed: CUDA "
                           f"error {-got} ({msg.decode(errors='replace')})")
    if got == 0:
        raise RuntimeError(f"{lib}: no cluster of {base.cl} blocks fits the "
                           f"card")
    return got


def launch_plan(lib: str, e: int, n: int, d: int, f: int, dtype: str,
                swiglu: bool) -> MlpPlan:
    """The plan a launch of `lib` takes: on the cluster tile, no more
    clusters than the card holds at once."""
    cap = cluster_capacity(lib, e, n, d, f, swiglu) if dtype in HALF_DTYPES \
        else None
    return mlp_plan(e, n, d, f, dtype, swiglu=swiglu, capacity=cap)


def tile_widths(d: int, f: int) -> tuple[int, int]:
    """The widths the cluster tile runs d and F at: each rounded up to a
    multiple of 8 (16-byte rows)."""
    return -(-d // 8) * 8, -(-f // 8) * 8


def padded_call(run, x, wg, wi, wo, d_to: int, f_to: int):
    """`run(x, wg, wi, wo)` on x (..., d), wg / wi (..., d, F), wo (..., F,
    d) zero-padded to d_to and F to f_to; the output sliced back to d.
    Exact: the padded x columns and weight rows add zero terms to the up
    projection, a padded hidden unit is silu(0) * 0 = 0 (gelu(0) = 0) and
    a zero row of wo adds nothing; the padded output columns are dropped."""
    d, f = x.shape[-1], wi.shape[-1]
    if (d_to, f_to) == (d, f):
        return run(x, wg, wi, wo)
    pd, pf = d_to - d, f_to - f
    out = run(F.pad(x, (0, pd)), None if wg is None else F.pad(wg, (0, pf, 0, pd)),
              F.pad(wi, (0, pf, 0, pd)), F.pad(wo, (0, pd, 0, pf)))
    return out[..., :d].contiguous()
