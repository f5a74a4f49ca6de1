"""First-order performance & energy model (the Timeloop/Accelergy stand-in).

Evaluates a *fusion group* (a consecutive run of operators mapped to one
pipeline stage) on a chiplet + memory configuration, producing the
piecewise-affine energy function of paper §4.3.1:

    E(T) = e_dyn + p_static * T     for T >= t_cmp,   infinite below.

All stage quantities are normalized PER SAMPLE so that stages running
different batch sizes (Insight 2: non-uniform batching) compose into one
pipeline with a common per-sample initiation interval T.

The scalar `evaluate_group` stays host Python, the reference path.  The
batched path (`_group_numeric` over a `ConfigGrid`) holds float64 tensors
on an explicit device and mirrors the scalar path operation for
operation: each NumPy operation of the reference is one torch operation
(no fused multiply-add), so the columns are bit-identical on the CPU and
on the card.  Caches that hold tensors are keyed by device.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import itertools
import math
from typing import Callable, Iterable, Sequence

import torch

from ..device import resolve_device

from .chiplets import (Chiplet, E_INTERCHIP_BIT, E_MAC_BASE, E_SRAM_BYTE)
from .engine import engine_enabled
from .memory import MEMORY_POOL, MemoryType
from .operators import Operator

TP_OPTIONS = (1, 2)                      # paper Table 4
BATCH_OPTIONS = (1, 2, 4, 8, 16, 32)     # per-stage microbatch choices
MEM_UNIT_OPTIONS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class StageConfig:
    chiplet: Chiplet
    memory: MemoryType
    mem_units: int
    tp: int
    batch: int

    @property
    def label(self) -> str:
        return (f"{self.chiplet.label}|{self.memory.name}x{self.mem_units}"
                f"|tp{self.tp}|b{self.batch}")

    def to_dict(self) -> dict:
        return {"chiplet": self.chiplet.to_dict(),
                "memory": self.memory.to_dict(),
                "mem_units": self.mem_units, "tp": self.tp,
                "batch": self.batch}

    @staticmethod
    def from_dict(d: dict) -> "StageConfig":
        return StageConfig(chiplet=Chiplet.from_dict(d["chiplet"]),
                           memory=MemoryType.from_dict(d["memory"]),
                           mem_units=d["mem_units"], tp=d["tp"],
                           batch=d["batch"])


@dataclasses.dataclass(frozen=True)
class StageOption:
    """One (chiplet, memory, tp, batch) choice for a fusion group, reduced
    to the piecewise-affine energy form. Per-sample units."""
    t_cmp: float          # min achievable per-sample latency (s)
    e_dyn: float          # dynamic energy per sample (J)
    p_static: float       # leakage power while stage is alive (W)
    hw_cost_usd: float    # manufacturing cost of this stage's hardware
    cfg: StageConfig
    group_name: str = ""
    flops_per_sample: float = 0.0   # useful FLOPs (utilization metrics)
    repeat: int = 1                 # physical copies of this stage

    def energy_at(self, t: float) -> float:
        if t < self.t_cmp:
            return math.inf
        return self.e_dyn + self.p_static * t

    def to_dict(self) -> dict:
        return {"t_cmp": self.t_cmp, "e_dyn": self.e_dyn,
                "p_static": self.p_static, "hw_cost_usd": self.hw_cost_usd,
                "cfg": self.cfg.to_dict(), "group_name": self.group_name,
                "flops_per_sample": self.flops_per_sample,
                "repeat": self.repeat}

    @staticmethod
    def from_dict(d: dict) -> "StageOption":
        return StageOption(
            t_cmp=d["t_cmp"], e_dyn=d["e_dyn"], p_static=d["p_static"],
            hw_cost_usd=d["hw_cost_usd"],
            cfg=StageConfig.from_dict(d["cfg"]),
            group_name=d["group_name"],
            flops_per_sample=d["flops_per_sample"], repeat=d["repeat"])


def _group_dram_bytes(ops: Sequence[Operator], glb_bytes: int,
                      batch: int) -> tuple[float, float]:
    """(dram_bytes, sram_bytes) for one batch-pass of the fused group.

    Tensor fusion keeps inter-operator intermediates in the GLB when they
    fit (half the GLB — the other half is the double buffer); spilled
    intermediates cost a DRAM write + read.
    """
    dram = 0.0
    sram = 0.0
    usable = glb_bytes / 2
    for i, op in enumerate(ops):
        w = op.weight_bytes
        if op.weight_reuse_divisor > 1.0:   # MoE: touched experts only
            w = min(op.weight_bytes,
                    (op.weight_bytes / op.weight_reuse_divisor) * batch)
        dram += w
        a_in = op.act_in_bytes * batch
        a_out = op.act_out_bytes * batch
        if i == 0:
            dram += a_in
        elif ops[i - 1].act_out_bytes * batch > usable:
            dram += a_in                     # re-read the spill
        if i == len(ops) - 1:
            dram += a_out
        elif a_out > usable:
            dram += a_out                    # spill write
        sram += (a_in + a_out)
    return dram, sram


def evaluate_group(ops: Sequence[Operator], cfg: StageConfig,
                   name: str = "") -> StageOption:
    """Roofline latency + energy for a fusion group on one stage config."""
    c, mem, B, tp = cfg.chiplet, cfg.memory, cfg.batch, cfg.tp

    t_compute = 0.0
    e_mac = 0.0
    sram_traffic = 0.0
    for op in ops:
        util = c.utilization(op.kind)
        # Small operators cannot fill a big array (Insight 4 / decode GEMV).
        size_eff = min(1.0, (op.parallel_work * B) / (c.n_pes * tp))
        rate = c.peak_flops * util * size_eff * tp
        t_compute += (op.flops * B) / max(rate, 1.0)
        e_mac += op.flops * B * 0.5 * E_MAC_BASE
        sram_traffic += ((op.act_in_bytes + op.act_out_bytes) * B
                         * c.sram_traffic_factor(op.kind))

    dram_bytes, _ = _group_dram_bytes(ops, c.glb_bytes * tp, B)
    bw = mem.bw_per_unit * cfg.mem_units
    t_mem = dram_bytes / bw

    # Tensor-parallel activation exchange (partial-sum/act reduce per op) +
    # handoff of the stage output to the next stage over the package link.
    out_bytes = ops[-1].act_out_bytes * B
    tp_bytes = sum(o.act_out_bytes for o in ops) * B * (tp - 1)
    t_comm = (tp_bytes + out_bytes) / c.interchip_bw
    e_link = (tp_bytes + out_bytes) * 8.0 * E_INTERCHIP_BIT

    # Double-buffered pipeline: compute overlaps DMA (Fig. 4 template).
    t_batch = max(t_compute, t_mem) + t_comm
    e_dyn = (e_mac + sram_traffic * E_SRAM_BYTE + mem.energy_j(dram_bytes)
             + e_link)
    return StageOption(
        t_cmp=t_batch / B,
        e_dyn=e_dyn / B,
        p_static=c.static_power_w * tp,
        hw_cost_usd=0.0,          # filled by costmodel.price_stage_options
        cfg=cfg,
        group_name=name,
        flops_per_sample=sum(o.flops for o in ops),
    )


def scale_option(o: StageOption, repeat: int) -> StageOption:
    """A fusion group repeated `repeat` times (e.g. one per transformer
    layer) contributes `repeat` physical pipeline stages that share one
    configuration: energy/cost/leakage scale, per-stage latency doesn't."""
    if repeat == 1:
        return o
    return dataclasses.replace(
        o, e_dyn=o.e_dyn * repeat, p_static=o.p_static * repeat,
        hw_cost_usd=o.hw_cost_usd * repeat,
        flops_per_sample=o.flops_per_sample * repeat, repeat=repeat)


F64 = torch.float64


def _empty(device: torch.device) -> torch.Tensor:
    return torch.empty(0, dtype=F64, device=device)


@dataclasses.dataclass(frozen=True)
class StageOptionColumns:
    """Column-major form of one (fusion group, chiplet SKU) option block.

    This is the value the per-SKU option cache stores and the process-pool
    warmup ships between processes: four float64 columns on one device
    plus the shared per-block metadata.  StageOption objects are
    materialized only when a solver actually selects one (the solvers copy
    their winners to the host in one transfer), which skips the dominant
    cost of eager enumeration — constructing tens of thousands of
    dataclass instances that the sweep never touches.
    """

    t_cmp: torch.Tensor
    e_dyn: torch.Tensor
    p_static: torch.Tensor
    hw_cost_usd: torch.Tensor
    cfgs: tuple[StageConfig, ...]
    group_name: str = ""
    flops_per_sample: float = 0.0
    repeat: int = 1
    # per-block derived caches (e.g. dominance-pruned indices), keyed by
    # the weighted flag; excluded from equality/repr.
    _derived: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    def __len__(self) -> int:
        return len(self.cfgs)

    @property
    def device(self) -> torch.device:
        return self.t_cmp.device

    def keep_idx(self, weighted: bool) -> torch.Tensor:
        """Indices of options not dominated within THIS block.  Within-
        block dominance implies full-set dominance, and dominance is
        transitive (including the earlier-index tie-break, which block
        concatenation order preserves), so pre-pruning per block before
        the cross-SKU pass keeps exactly the full-set survivor set —
        while caching the quadratic mask per block, shared by every
        pool and genome that reuses the block."""
        got = self._derived.get(weighted)
        if got is None:
            w = torch.clamp_min(self.hw_cost_usd, 1e-9) if weighted else 1.0
            got = torch.nonzero(envelope_keep_mask(
                self.t_cmp, self.p_static * w, self.e_dyn * w)).flatten()
            self._derived[weighted] = got
        return got

    def option_with(self, i: int, t_cmp: float, e_dyn: float,
                    p_static: float, hw_cost_usd: float) -> StageOption:
        """Option i from its four column values, already on the host."""
        return StageOption(
            t_cmp=t_cmp, e_dyn=e_dyn, p_static=p_static,
            hw_cost_usd=hw_cost_usd, cfg=self.cfgs[i],
            group_name=self.group_name,
            flops_per_sample=self.flops_per_sample, repeat=self.repeat)

    def option(self, i: int) -> StageOption:
        """Materialize option i — bit-identical to eager enumeration
        (the floats are copied verbatim from the batched evaluation)."""
        vals = torch.stack([self.t_cmp[i], self.e_dyn[i], self.p_static[i],
                            self.hw_cost_usd[i]]).tolist()
        return self.option_with(i, *vals)

    def options(self) -> tuple[StageOption, ...]:
        rows = torch.stack([self.t_cmp, self.e_dyn, self.p_static,
                            self.hw_cost_usd], dim=1).tolist()
        return tuple(self.option_with(i, *r) for i, r in enumerate(rows))


_option_set_uid = itertools.count()


class StageOptionSet(Sequence):
    """A sequence of StageOptions with lazily-built column tensors.

    `solve_pipeline` consumes the (t_cmp, e_dyn, p_static, hw_cost)
    columns directly when sweeping the iso-latency grid, so the tensors
    are built once per cached option set instead of once per GA genome.

    Two construction modes: from materialized StageOptions (the seed
    path; the columns are built on `device`, the CPU when None), or via
    `from_blocks` from per-SKU StageOptionColumns (the engine path) —
    there the columns are concatenated blocks on the blocks' device and
    individual StageOptions materialize only on demand (`row_view` and
    `option_from`, in a solver's second pass).  `uid` is a process-unique token used to
    memoize derived values (e.g. the default latency grid) per option
    set without risking id() reuse after garbage collection.
    """

    __slots__ = ("_options", "_blocks", "_offsets", "_cols", "_rows",
                 "_pruned", "device", "uid")

    def __init__(self, options: Iterable[StageOption] = (),
                 device: str | torch.device | None = None):
        self._options: tuple[StageOption, ...] | None = tuple(options)
        self._blocks: tuple[StageOptionColumns, ...] | None = None
        self._offsets: list[int] | None = None
        self._cols: tuple[torch.Tensor, ...] | None = None
        self._rows: torch.Tensor | None = None
        self._pruned: dict[bool, tuple] = {}
        self.device = torch.device("cpu" if device is None else device)
        self.uid = next(_option_set_uid)

    @classmethod
    def from_blocks(cls, blocks: Iterable[StageOptionColumns],
                    device: str | torch.device) -> "StageOptionSet":
        self = cls.__new__(cls)
        self._options = None
        self._blocks = tuple(blocks)
        offs = [0]
        for b in self._blocks:
            offs.append(offs[-1] + len(b))
        self._offsets = offs
        self._cols = None
        self._rows = None
        self._pruned = {}
        self.device = torch.device(device)
        self.uid = next(_option_set_uid)
        return self

    @property
    def options(self) -> tuple[StageOption, ...]:
        if self._options is None:
            self._options = tuple(o for b in self._blocks
                                  for o in b.options())
        return self._options

    def __len__(self) -> int:
        if self._options is not None:
            return len(self._options)
        return self._offsets[-1]

    def __getitem__(self, i):
        if self._options is not None:
            return self._options[i]
        if isinstance(i, slice):
            return self.options[i]
        n = self._offsets[-1]
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        b = bisect.bisect_right(self._offsets, i) - 1
        return self._blocks[b].option(i - self._offsets[b])

    def __iter__(self):
        if self._options is not None:
            return iter(self._options)
        return (o for b in self._blocks for o in b.options())

    def columns(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
        if self._cols is None:
            if self._blocks is not None:
                bl = [b for b in self._blocks if len(b)]
                if not bl:
                    self._cols = (_empty(self.device),) * 4
                else:
                    self._cols = (
                        torch.cat([b.t_cmp for b in bl]),
                        torch.cat([b.e_dyn for b in bl]),
                        torch.cat([b.p_static for b in bl]),
                        torch.cat([b.hw_cost_usd for b in bl]))
            else:
                o = self._options
                vals = torch.tensor(
                    [[x.t_cmp for x in o], [x.e_dyn for x in o],
                     [x.p_static for x in o], [x.hw_cost_usd for x in o]],
                    dtype=F64, device=self.device).reshape(4, len(o))
                self._cols = tuple(vals.unbind(0))
        return self._cols

    @property
    def columnar(self) -> bool:
        """True while the options exist only as column blocks."""
        return self._options is None

    def row_view(self, i: int) -> torch.Tensor:
        """Option i's (t_cmp, e_dyn, p_static, hw_cost) as a (1, 4) view
        on the set's device (a column-built set), for solvers that copy
        all their winners to the host at once."""
        if self._rows is None:
            self._rows = torch.stack(self.columns(), dim=1)
        return self._rows[i:i + 1]

    def option_from(self, i: int, vals: Sequence[float]) -> StageOption:
        """Option i of a column-built set from its `row_view` values,
        copied to the host — bit-identical to `self[i]`."""
        b = bisect.bisect_right(self._offsets, i) - 1
        return self._blocks[b].option_with(i - self._offsets[b], *vals)

    def pruned(self, weighted: bool) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor, torch.Tensor]:
        """(t_cmp, slope, intercept, original_index) restricted to
        non-dominated options — exact: pruning never changes the envelope
        minimum at any latency, nor the hull engine's tie-break winner.

        Block-built sets prune in two exact stages: each block's cached
        within-block survivors first (see StageOptionColumns.keep_idx),
        then the cross-SKU mask over the much smaller concatenation —
        transitivity of the dominance relation makes the final survivor
        set identical to a one-shot full mask."""
        cached = self._pruned.get(weighted)
        if cached is not None:
            return cached
        if self._blocks is not None:
            ts, ss, cs, gs = [], [], [], []
            for b, off in zip(self._blocks, self._offsets):
                if not len(b):
                    continue
                kidx = b.keep_idx(weighted)
                w = (torch.clamp_min(b.hw_cost_usd[kidx], 1e-9) if weighted
                     else 1.0)
                ts.append(b.t_cmp[kidx])
                ss.append(b.p_static[kidx] * w)
                cs.append(b.e_dyn[kidx] * w)
                gs.append(off + kidx)
            if not ts:
                empty = _empty(self.device)
                cached = (empty, empty, empty,
                          torch.empty(0, dtype=torch.int64, device=self.device))
            else:
                t_cmp = torch.cat(ts)
                slope = torch.cat(ss)
                icept = torch.cat(cs)
                gidx = torch.cat(gs)
                keep = torch.nonzero(envelope_keep_mask(t_cmp, slope,
                                                        icept)).flatten()
                cached = (t_cmp[keep], slope[keep], icept[keep],
                          gidx[keep])
        else:
            t_cmp, e_dyn, p_static, hw = self.columns()
            w = torch.clamp_min(hw, 1e-9) if weighted else 1.0
            slope, icept = p_static * w, e_dyn * w
            idx = torch.nonzero(envelope_keep_mask(t_cmp, slope,
                                                   icept)).flatten()
            cached = (t_cmp[idx], slope[idx], icept[idx], idx)
        self._pruned[weighted] = cached
        return cached


def envelope_keep_mask(t_cmp: torch.Tensor, slope: torch.Tensor,
                       icept: torch.Tensor) -> torch.Tensor:
    """Mask of options NOT dominated by a single other option.

    Option j is dominated by k when k activates no later (t_cmp_k <=
    t_cmp_j) and its line lies at-or-below j's everywhere (slope and
    intercept both <=), with either some strict inequality or, for exact
    duplicates, an earlier index (matching the hull's first-insert-wins
    tie-break).  Every removed option has a surviving dominator, so the
    envelope minimum — and the chosen payload under the (value, t_cmp,
    index) tie-break — is unchanged at every query latency.
    """
    m = t_cmp.numel()
    if m <= 2:
        return torch.ones(m, dtype=torch.bool, device=t_cmp.device)
    le = ((t_cmp[:, None] <= t_cmp) & (slope[:, None] <= slope)
          & (icept[:, None] <= icept))
    strict = ((t_cmp[:, None] < t_cmp) | (slope[:, None] < slope)
              | (icept[:, None] < icept))
    order = torch.arange(m, device=t_cmp.device)
    dominated = torch.any(le & (strict | (order[:, None] < order)), dim=0)
    return ~dominated


class ConfigGrid:
    """A (chiplet, memory, mem_units, tp, batch) config grid with hoisted
    per-config numeric columns.

    The grid for a fusion group depends on the group's ops only through
    its memory-capacity footprint, so identical grids recur constantly
    across fusion groups, genomes, and SA iterations; `config_grid`
    memoizes them.  The config-derived numeric columns (batch, tp,
    mem_units, bandwidth, DRAM energy) and the per-cost-function cost
    rows are built once per distinct grid and device and reused by every
    batched group evaluation on it ("grid hoisting").  The grid itself is
    host data; its tensors are cached per device."""

    __slots__ = ("cfgs", "chips", "chip_idx", "_index", "_numeric",
                 "_cost_rows")

    def __init__(self, cfgs: Iterable[StageConfig]):
        self.cfgs = tuple(cfgs)
        chip_index: dict[Chiplet, int] = {}
        chips: list[Chiplet] = []
        idx: list[int] = []
        for cfg in self.cfgs:
            i = chip_index.get(cfg.chiplet)
            if i is None:
                i = chip_index[cfg.chiplet] = len(chips)
                chips.append(cfg.chiplet)
            idx.append(i)
        self.chips = tuple(chips)       # first-appearance order
        self.chip_idx = tuple(idx)
        self._index: dict[torch.device, torch.Tensor] = {}
        self._numeric: dict[torch.device, tuple[torch.Tensor, ...]] = {}
        self._cost_rows: dict[tuple, torch.Tensor] = {}

    def __len__(self) -> int:
        return len(self.cfgs)

    def index(self, device: torch.device) -> torch.Tensor:
        """`chip_idx` as a tensor on `device`."""
        got = self._index.get(device)
        if got is None:
            got = self._index[device] = torch.tensor(
                self.chip_idx, dtype=torch.int64, device=device)
        return got

    def numeric(self, device: torch.device
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
        """(batch, tp, mem_units, bw_per_unit, pj_per_bit) columns."""
        got = self._numeric.get(device)
        if got is None:
            cfgs = self.cfgs
            got = self._numeric[device] = tuple(torch.tensor(
                [[c.batch for c in cfgs], [c.tp for c in cfgs],
                 [c.mem_units for c in cfgs],
                 [c.memory.bw_per_unit for c in cfgs],
                 [c.memory.pj_per_bit for c in cfgs]],
                dtype=F64, device=device).unbind(0))
        return got

    def cost_row(self, cost_fn: Callable[[StageConfig], float],
                 device: torch.device) -> torch.Tensor:
        row = self._cost_rows.get((cost_fn, device))
        if row is None:
            row = self._cost_rows[(cost_fn, device)] = torch.tensor(
                [cost_fn(c) for c in self.cfgs], dtype=F64, device=device)
        return row


def _build_config_grid(pool: tuple[Chiplet, ...],
                       memories: tuple[MemoryType, ...],
                       batches: tuple[int, ...], tps: tuple[int, ...],
                       fixed_batch: int | None, max_mem_units: int,
                       min_units_by_memory: tuple[int, ...]
                       ) -> list[StageConfig]:
    bs = (fixed_batch,) if fixed_batch is not None else batches
    cfgs: list[StageConfig] = []
    for c in pool:
        for m, min_units in zip(memories, min_units_by_memory):
            if min_units > max_mem_units:
                continue
            for units in sorted({min_units, min(min_units * 2, max_mem_units),
                                 max_mem_units}):
                for tp in tps:
                    for b in bs:
                        cfgs.append(StageConfig(chiplet=c, memory=m,
                                                mem_units=units, tp=tp,
                                                batch=b))
    return cfgs


@functools.lru_cache(maxsize=65536)
def _config_grid_cached(pool: tuple, memories: tuple, batches: tuple,
                        tps: tuple, fixed_batch: int | None,
                        max_mem_units: int,
                        min_units_by_memory: tuple[int, ...]) -> ConfigGrid:
    return ConfigGrid(_build_config_grid(pool, memories, batches, tps,
                                         fixed_batch, max_mem_units,
                                         min_units_by_memory))


def _group_capacity(ops: Sequence[Operator]) -> float:
    return sum(o.weight_bytes for o in ops) + \
        max((o.act_in_bytes + o.act_out_bytes) for o in ops)


def config_grid(ops: Sequence[Operator], pool: Sequence[Chiplet],
                memories: Sequence[MemoryType] = MEMORY_POOL,
                batches: Sequence[int] = BATCH_OPTIONS,
                tps: Sequence[int] = TP_OPTIONS,
                fixed_batch: int | None = None,
                max_mem_units: int = 8) -> ConfigGrid:
    """Memoized ConfigGrid for a fusion group (the engine path).

    The group's ops enter the grid only through the per-memory minimum
    unit count its capacity footprint implies, so the cache is keyed on
    that small derived tuple rather than the raw capacity — groups with
    different weights but the same memory-unit needs share one grid
    (and its hoisted numeric columns and cost rows)."""
    capacity = _group_capacity(ops)
    memories = tuple(memories)
    min_units = tuple(m.units_for(capacity, 0) for m in memories)
    return _config_grid_cached(tuple(pool), memories, tuple(batches),
                               tuple(tps), fixed_batch, max_mem_units,
                               min_units)


@functools.lru_cache(maxsize=65536)
def _chip_rows_cached(chips: tuple[Chiplet, ...], kinds: tuple[str, ...],
                      device: torch.device) -> torch.Tensor:
    """Chiplet-derived model parameters per (chip set, operator kinds) on
    `device` — the only ops-dependence is through the kinds, so rows are
    shared across every fusion group with the same operator-kind
    signature."""
    return torch.tensor([(c.peak_flops, c.n_pes, c.glb_bytes,
                          c.static_power_w, c.interchip_bw,
                          *(c.utilization(k) for k in kinds),
                          *(c.sram_traffic_factor(k) for k in kinds))
                         for c in chips], dtype=F64, device=device)


def clear_perfmodel_caches() -> None:
    _config_grid_cached.cache_clear()
    _chip_rows_cached.cache_clear()


def stage_config_grid(ops: Sequence[Operator],
                      pool: Sequence[Chiplet],
                      memories: Sequence[MemoryType] = MEMORY_POOL,
                      batches: Sequence[int] = BATCH_OPTIONS,
                      tps: Sequence[int] = TP_OPTIONS,
                      fixed_batch: int | None = None,
                      max_mem_units: int = 8) -> list[StageConfig]:
    """The exact (chiplet, memory, mem_units, tp, batch) tuples a fusion
    group is evaluated on — the `M` axis of Algorithm 1.  Built fresh on
    every call (the seed path is deliberately uncached; the engine path
    goes through the memoized `config_grid`)."""
    memories = tuple(memories)
    capacity = _group_capacity(ops)
    min_units = tuple(m.units_for(capacity, 0) for m in memories)
    return _build_config_grid(tuple(pool), memories, tuple(batches),
                              tuple(tps), fixed_batch, max_mem_units,
                              min_units)


def _group_numeric(ops: Sequence[Operator], grid: ConfigGrid,
                   device: torch.device
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched roofline evaluation of a fusion group over a config grid:
    (t_cmp, e_dyn per sample, p_static) columns on `device`, before
    repeat scaling.

    Every arithmetic step mirrors the scalar `evaluate_group` path
    operation-for-operation (same association order, IEEE float64
    throughout, one torch operation per operation: no fused multiply-add,
    no division by a reciprocal), so the columns are bit-identical to
    per-config calls on any device.  Chiplet-derived values are computed
    once per distinct chiplet and gathered; config-derived columns come
    prebuilt from the grid.
    """
    n = len(grid)
    rows = _chip_rows_cached(grid.chips, tuple(op.kind for op in ops),
                             device)[grid.index(device)]
    peak, n_pes, glb, p_stat, ic_bw = rows[:, :5].T
    util = rows[:, 5:5 + len(ops)].T
    stf = rows[:, 5 + len(ops):].T
    B, tp, units, bw_pu, pj_bit = grid.numeric(device)

    t_compute = torch.zeros(n, dtype=F64, device=device)
    e_mac = torch.zeros(n, dtype=F64, device=device)
    sram_traffic = torch.zeros(n, dtype=F64, device=device)
    for i, op in enumerate(ops):
        size_eff = torch.clamp_max((op.parallel_work * B) / (n_pes * tp), 1.0)
        rate = peak * util[i] * size_eff * tp
        t_compute += (op.flops * B) / torch.clamp_min(rate, 1.0)
        e_mac += op.flops * B * 0.5 * E_MAC_BASE
        sram_traffic += (op.act_in_bytes + op.act_out_bytes) * B * stf[i]

    # _group_dram_bytes, vectorized over (glb*tp, B).
    usable = glb * tp / 2
    dram = torch.zeros(n, dtype=F64, device=device)
    for i, op in enumerate(ops):
        w = op.weight_bytes
        if op.weight_reuse_divisor > 1.0:
            dram += torch.clamp_max(
                (op.weight_bytes / op.weight_reuse_divisor) * B,
                op.weight_bytes)
        else:
            dram += w
        a_in = op.act_in_bytes * B
        a_out = op.act_out_bytes * B
        if i == 0:
            dram += a_in
        else:
            dram += torch.where(ops[i - 1].act_out_bytes * B > usable,
                                a_in, 0.0)
        if i == len(ops) - 1:
            dram += a_out
        else:
            dram += torch.where(a_out > usable, a_out, 0.0)

    bw = bw_pu * units
    t_mem = dram / bw

    out_bytes = ops[-1].act_out_bytes * B
    tp_bytes = sum(o.act_out_bytes for o in ops) * B * (tp - 1)
    t_comm = (tp_bytes + out_bytes) / ic_bw
    e_link = (tp_bytes + out_bytes) * 8.0 * E_INTERCHIP_BIT

    t_batch = torch.maximum(t_compute, t_mem) + t_comm
    e_mem = dram * 8.0 * pj_bit * 1e-12
    e_dyn = (e_mac + sram_traffic * E_SRAM_BYTE + e_mem + e_link)

    return t_batch / B, e_dyn / B, p_stat * tp


def _scaled_group_columns(ops: Sequence[Operator], grid: ConfigGrid,
                          cost_fn: Callable[[StageConfig], float] | None,
                          repeat: int, device: torch.device
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor, float]:
    """(t_cmp, e_dyn, p_static, hw_cost, flops_per_sample) with repeat
    folded in — scale_option semantics: energy/leakage/cost/FLOPs scale
    with the physical copy count, per-stage latency doesn't."""
    t_cmp, e_per, p_static = _group_numeric(ops, grid, device)
    flops_per_sample = sum(o.flops for o in ops)
    if repeat != 1:
        e_per = e_per * repeat
        p_static = p_static * repeat
        flops_per_sample = flops_per_sample * repeat
    if cost_fn is None:
        hw = torch.zeros(len(grid), dtype=F64, device=device)
    else:
        hw = grid.cost_row(cost_fn, device) * repeat
    return t_cmp, e_per, p_static, hw, flops_per_sample


def evaluate_group_batch(ops: Sequence[Operator],
                         cfgs: "Sequence[StageConfig] | ConfigGrid",
                         name: str = "",
                         cost_fn: Callable[[StageConfig], float] | None = None,
                         repeat: int = 1,
                         device: str | torch.device | None = None
                         ) -> list[StageOption]:
    """Vectorized `evaluate_group` over a list of stage configs, on
    `device` (the card unless the caller names another).

    The numeric core (`_group_numeric`) mirrors the scalar path
    operation-for-operation, so the returned StageOptions are
    bit-identical to per-config `evaluate_group` calls.  repeat > 1
    additionally folds `scale_option` into construction.  The columns
    come to the host in one copy.
    """
    if not len(cfgs):
        return []
    dev = resolve_device(device)
    grid = cfgs if isinstance(cfgs, ConfigGrid) else ConfigGrid(cfgs)
    t_cmp, e_per, p_static, hw, flops_per_sample = _scaled_group_columns(
        ops, grid, cost_fn, repeat, dev)
    t_cmp_l, e_per_l, p_static_l, hw_l = torch.stack(
        [t_cmp, e_per, p_static, hw]).tolist()
    return [StageOption(
        t_cmp=t_cmp_l[j], e_dyn=e_per_l[j], p_static=p_static_l[j],
        hw_cost_usd=hw_l[j],
        cfg=cfg, group_name=name, flops_per_sample=flops_per_sample,
        repeat=repeat)
        for j, cfg in enumerate(grid.cfgs)]


def evaluate_group_columns(ops: Sequence[Operator], grid: ConfigGrid,
                           name: str = "",
                           cost_fn: Callable[[StageConfig], float]
                           | None = None,
                           repeat: int = 1,
                           device: str | torch.device | None = None
                           ) -> StageOptionColumns:
    """Column form of `evaluate_group_batch`: same numeric core, no
    per-option object construction; the columns stay on `device`."""
    dev = resolve_device(device)
    if not len(grid):
        empty = _empty(dev)
        return StageOptionColumns(
            t_cmp=empty, e_dyn=empty, p_static=empty, hw_cost_usd=empty,
            cfgs=(), group_name=name,
            flops_per_sample=(sum(o.flops for o in ops)
                              * (repeat if repeat != 1 else 1)),
            repeat=repeat)
    t_cmp, e_per, p_static, hw, flops_per_sample = _scaled_group_columns(
        ops, grid, cost_fn, repeat, dev)
    return StageOptionColumns(
        t_cmp=t_cmp, e_dyn=e_per, p_static=p_static, hw_cost_usd=hw,
        cfgs=grid.cfgs, group_name=name,
        flops_per_sample=flops_per_sample, repeat=repeat)


def enumerate_stage_options(
        ops: Sequence[Operator],
        pool: Sequence[Chiplet],
        memories: Sequence[MemoryType] = MEMORY_POOL,
        batches: Sequence[int] = BATCH_OPTIONS,
        tps: Sequence[int] = TP_OPTIONS,
        name: str = "",
        fixed_batch: int | None = None,
        max_mem_units: int = 8,
        vectorize: bool | None = None,
        cost_fn: Callable[[StageConfig], float] | None = None,
        repeat: int = 1,
        device: str | torch.device | None = None) -> list[StageOption]:
    """All StageOptions for a fusion group: the `M` of Algorithm 1.

    vectorize=None follows the global engine switch; the scalar and
    batched paths produce identical options.  The batched path runs on
    `device` (the card unless the caller names another); the scalar path
    is host Python.  cost_fn, when given, fills hw_cost_usd at
    construction (saves a re-pricing pass); repeat folds `scale_option`
    into construction.
    """
    if vectorize is None:
        vectorize = engine_enabled()
    if vectorize:
        grid = config_grid(ops, pool, memories=memories, batches=batches,
                           tps=tps, fixed_batch=fixed_batch,
                           max_mem_units=max_mem_units)
        return evaluate_group_batch(ops, grid, name=name, cost_fn=cost_fn,
                                    repeat=repeat, device=device)
    cfgs = stage_config_grid(ops, pool, memories=memories, batches=batches,
                             tps=tps, fixed_batch=fixed_batch,
                             max_mem_units=max_mem_units)
    out = [evaluate_group(ops, cfg, name=name) for cfg in cfgs]
    if cost_fn is not None:
        out = [dataclasses.replace(o, hw_cost_usd=cost_fn(o.cfg))
               for o in out]
    if repeat != 1:
        out = [scale_option(o, repeat) for o in out]
    return out


def enumerate_stage_options_by_chiplet(
        ops: Sequence[Operator],
        chiplets: Sequence[Chiplet],
        memories: Sequence[MemoryType] = MEMORY_POOL,
        batches: Sequence[int] = BATCH_OPTIONS,
        tps: Sequence[int] = TP_OPTIONS,
        name: str = "",
        fixed_batch: int | None = None,
        max_mem_units: int = 8,
        cost_fn: Callable[[StageConfig], float] | None = None,
        repeat: int = 1,
        device: str | torch.device | None = None
        ) -> dict[Chiplet, tuple[StageOption, ...]]:
    """One `evaluate_group_batch` call covering several chiplet SKUs at
    once, split back per SKU.

    `stage_config_grid` emits each chiplet's configs contiguously and the
    batched evaluation is row-wise element-wise, so every per-SKU slice is
    bit-identical to a separate single-SKU `enumerate_stage_options` call.
    """
    opts = enumerate_stage_options(ops, chiplets, memories=memories,
                                   batches=batches, tps=tps, name=name,
                                   fixed_batch=fixed_batch,
                                   max_mem_units=max_mem_units,
                                   vectorize=True, cost_fn=cost_fn,
                                   repeat=repeat, device=device)
    out: dict[Chiplet, list[StageOption]] = {c: [] for c in chiplets}
    for o in opts:
        out[o.cfg.chiplet].append(o)
    return {c: tuple(v) for c, v in out.items()}


def enumerate_stage_columns_by_chiplet(
        ops: Sequence[Operator],
        chiplets: Sequence[Chiplet],
        memories: Sequence[MemoryType] = MEMORY_POOL,
        batches: Sequence[int] = BATCH_OPTIONS,
        tps: Sequence[int] = TP_OPTIONS,
        name: str = "",
        fixed_batch: int | None = None,
        max_mem_units: int = 8,
        cost_fn: Callable[[StageConfig], float] | None = None,
        repeat: int = 1,
        device: str | torch.device | None = None
        ) -> dict[Chiplet, StageOptionColumns]:
    """Column form of `enumerate_stage_options_by_chiplet`: one batched
    evaluation over all SKUs' configs on `device`, split back into
    per-SKU StageOptionColumns blocks.

    `config_grid` emits each chiplet's configs contiguously and the
    batched evaluation is row-wise element-wise, so every per-SKU block
    is bit-identical to a separate single-SKU enumeration.  The split
    columns are copied so a cached block never pins the whole-pool
    evaluation buffers.  This is the population-batch entry point: the
    Layer-2 GA enumerates all missing (fusion group, SKU) pairs of a
    whole genome population through it.
    """
    dev = resolve_device(device)
    grid = config_grid(ops, chiplets, memories=memories, batches=batches,
                       tps=tps, fixed_batch=fixed_batch,
                       max_mem_units=max_mem_units)
    block = evaluate_group_columns(ops, grid, name=name, cost_fn=cost_fn,
                                   repeat=repeat, device=dev)
    spans: dict[Chiplet, list[int]] = {}
    for j, cfg in enumerate(grid.cfgs):
        span = spans.get(cfg.chiplet)
        if span is None:
            spans[cfg.chiplet] = [j, j + 1]
        else:
            span[1] = j + 1             # contiguous by construction
    empty = _empty(dev)
    out: dict[Chiplet, StageOptionColumns] = {}
    for c in chiplets:
        span = spans.get(c)
        if span is None:
            out[c] = StageOptionColumns(
                t_cmp=empty, e_dyn=empty, p_static=empty,
                hw_cost_usd=empty, cfgs=(), group_name=name,
                flops_per_sample=block.flops_per_sample, repeat=repeat)
            continue
        lo, hi = span
        out[c] = StageOptionColumns(
            t_cmp=block.t_cmp[lo:hi].clone(),
            e_dyn=block.e_dyn[lo:hi].clone(),
            p_static=block.p_static[lo:hi].clone(),
            hw_cost_usd=block.hw_cost_usd[lo:hi].clone(),
            cfgs=grid.cfgs[lo:hi], group_name=name,
            flops_per_sample=block.flops_per_sample, repeat=repeat)
    return out


def is_memory_bound(op: Operator, chiplet: Chiplet, mem: MemoryType,
                    batch: int = 1) -> bool:
    """Insight 1 classifier: does this operator saturate bandwidth before
    compute on the given hardware?"""
    util = chiplet.utilization(op.kind)
    size_eff = min(1.0, op.parallel_work * batch / chiplet.n_pes)
    t_c = op.flops * batch / max(chiplet.peak_flops * util * size_eff, 1.0)
    t_m = op.dram_bytes(batch) / mem.bw_per_unit
    return t_m > t_c


# ---------------------------------------------------------------------------
# GPU baseline (paper §5) — MODELED, not measured: no A100 in this
# environment.  Parameters documented; benchmarks flag this column
# "modeled".
# ---------------------------------------------------------------------------

GPU_PEAK_FLOPS = 312e12        # A100 bf16 dense
GPU_HBM_BW = 1.555e12          # bytes/s
GPU_TDP_W = 400.0
GPU_IDLE_W = 45.0              # measured idle power cited in paper §5
GPU_COST_USD = 10_000.0        # the paper's optimistic A100 price
GPU_KERNEL_OVERHEAD_S = 4e-6   # per-kernel launch (CUDA-graph amortized)
GPU_UTIL = {"gemm": 0.45, "conv": 0.35, "dwconv": 0.06, "attention": 0.30,
            "elementwise": 0.04, "norm": 0.04, "scan": 0.05, "embed": 0.10}


def gpu_eval(ops: Iterable[Operator], repeats: Iterable[int],
             batch: int = 1) -> tuple[float, float]:
    """(latency_s, energy_J) per batch on the modeled GPU."""
    t_total = 0.0
    for op, r in zip(ops, repeats):
        util = GPU_UTIL[op.kind]
        size_eff = min(1.0, op.parallel_work * batch / (GPU_PEAK_FLOPS / 2e9))
        t_c = op.flops * batch / (GPU_PEAK_FLOPS * util * max(size_eff, 1e-3))
        t_m = op.dram_bytes(batch) / GPU_HBM_BW
        t_total += (max(t_c, t_m) + GPU_KERNEL_OVERHEAD_S) * r
    energy = GPU_TDP_W * t_total
    return t_total, energy
