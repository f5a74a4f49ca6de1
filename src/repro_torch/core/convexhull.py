"""Iso-latency layer codesign via the modified convex hull trick
(paper §4.3, Algorithm 1).

Per pipeline stage, every (chiplet, memory, tp, batch) option induces a
piecewise-affine energy function of the stage latency T:

    E(T) = e_dyn + p_static * T   for T >= t_cmp,   +inf below.

Fixing the pipeline initiation interval T decouples the stages, so the
joint O(M^P) search collapses to, per stage, "evaluate the lower envelope
of M piecewise-affine functions at Q latencies".  The *modified* part:
functions activate at different thresholds t_cmp, so the envelope is
maintained incrementally — options are sorted by activation point and
inserted into a dynamic lower hull as the query latency sweeps upward
(Algorithm 1's SortTCompute / BinarySearchInsert / RemoveIrrelevant).

Complexity: O(P * (M log M + Q log M)), as claimed in §4.3.4.

Two interchangeable scalar envelope engines are provided and
cross-tested, both host Python:
  * DynamicLowerHull — the paper's literal structure;
  * LiChaoTree       — same asymptotics, used as an independent oracle.

The vectorized sweeps (`_solve_pipeline_tensor`, `stage_envelope_sweep`,
`solve_pipeline_batch`) run on float64 tensors on the caller's device:
masked (options x latencies) matrices, segmented minima, and first-minimum
tie-breaks.  Each NumPy operation of the reference is one torch operation
and the per-stage sums keep their order, so values, winners and
tie-breaks are bit-identical to the reference on the CPU and on the card.
Only the winners come back to the host.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .engine import engine_enabled
from .perfmodel import F64, StageOption, StageOptionSet, envelope_keep_mask


@dataclasses.dataclass
class Line:
    """y = slope * x + intercept, tagged with its originating option."""

    slope: float
    intercept: float
    payload: object = None

    def at(self, x: float) -> float:
        return self.slope * x + self.intercept


# ---------------------------------------------------------------------------
# Dynamic lower hull with arbitrary-order insertion (paper Algorithm 1)
# ---------------------------------------------------------------------------


class DynamicLowerHull:
    """Lower envelope of lines; supports insertion in arbitrary slope order
    (BinarySearchInsert + RemoveIrrelevant) and O(log M) min-queries."""

    def __init__(self):
        self._lines: list[Line] = []  # sorted by slope, envelope-only

    @staticmethod
    def _bad(l1: Line, l2: Line, l3: Line) -> bool:
        """True if l2 is everywhere dominated by l1 and l3."""
        # intersection_x(l1,l3) <= intersection_x(l1,l2)  =>  l2 useless
        return (l3.intercept - l1.intercept) * (l2.slope - l1.slope) <= (
            l2.intercept - l1.intercept
        ) * (l3.slope - l1.slope)

    def insert(self, line: Line) -> None:
        lines = self._lines
        slopes = [l.slope for l in lines]
        pos = bisect.bisect_left(slopes, line.slope)
        # Equal slope: keep only the lower intercept.
        if pos < len(lines) and lines[pos].slope == line.slope:
            if lines[pos].intercept <= line.intercept:
                return
            lines.pop(pos)
        # Would the new line itself be dominated?
        if 0 < pos < len(lines) and self._bad(lines[pos - 1], line, lines[pos]):
            return
        lines.insert(pos, line)
        # RemoveIrrelevant: drop dominated neighbours on both sides.
        i = pos + 1
        while 0 < i < len(lines) - 1 and self._bad(lines[i - 1], lines[i], lines[i + 1]):
            lines.pop(i)
        i = pos - 1
        while 0 < i < len(lines) - 1 and self._bad(lines[i - 1], lines[i], lines[i + 1]):
            lines.pop(i)
            i -= 1

    def query(self, x: float) -> Line | None:
        """Line attaining the envelope minimum at x (binary search over
        breakpoints; the envelope value is unimodal along the hull)."""
        lines = self._lines
        if not lines:
            return None
        lo, hi = 0, len(lines) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if lines[mid].at(x) <= lines[mid + 1].at(x):
                hi = mid
            else:
                lo = mid + 1
        return lines[lo]


# ---------------------------------------------------------------------------
# Li Chao tree over a fixed query grid (independent oracle, same use)
# ---------------------------------------------------------------------------


class LiChaoTree:
    def __init__(self, xs: Sequence[float]):
        self._xs = sorted(xs)
        self._n = max(1, len(self._xs))
        self._seg: dict[int, Line] = {}

    def _ins(self, node: int, lo: int, hi: int, line: Line) -> None:
        cur = self._seg.get(node)
        if cur is None:
            self._seg[node] = line
            return
        mid = (lo + hi) // 2
        xm = self._xs[mid]
        if line.at(xm) < cur.at(xm):
            self._seg[node], line = line, cur
            cur = self._seg[node]
        if lo == hi:
            return
        if line.at(self._xs[lo]) < cur.at(self._xs[lo]):
            self._ins(2 * node, lo, mid, line)
        elif line.at(self._xs[hi]) < cur.at(self._xs[hi]):
            self._ins(2 * node + 1, mid + 1, hi, line)

    def insert(self, line: Line) -> None:
        self._ins(1, 0, self._n - 1, line)

    def query_idx(self, i: int) -> Line | None:
        node, lo, hi = 1, 0, self._n - 1
        best: Line | None = None
        x = self._xs[i]
        while True:
            cur = self._seg.get(node)
            if cur is not None and (best is None or cur.at(x) < best.at(x)):
                best = cur
            if lo == hi:
                return best
            mid = (lo + hi) // 2
            if i <= mid:
                node, hi = 2 * node, mid
            else:
                node, lo = 2 * node + 1, mid + 1


# ---------------------------------------------------------------------------
# Stage envelope: iso-latency sweep with activation thresholds
# ---------------------------------------------------------------------------


def stage_envelope(
    options: Sequence[StageOption],
    latencies: Sequence[float],
    cost_weight: Callable[[StageOption], float] = lambda o: 1.0,
    engine: str = "hull",
) -> list[tuple[float, StageOption | None]]:
    """For each query latency T (ascending), the minimum of
    cost_weight(o) * (e_dyn + p_static*T) over options with t_cmp <= T.

    Returns [(value, argmin_option)] aligned with `latencies`.
    """
    lat = list(latencies)
    order = sorted(range(len(lat)), key=lat.__getitem__)
    opts = sorted(options, key=lambda o: o.t_cmp)  # SortTCompute
    use_lichao = engine == "lichao"
    hull = LiChaoTree([lat[i] for i in order]) if use_lichao else DynamicLowerHull()

    out: list[tuple[float, StageOption | None]] = [(math.inf, None)] * len(lat)
    j = 0
    for qi, i in enumerate(order):
        T = lat[i]
        while j < len(opts) and opts[j].t_cmp <= T:
            w = cost_weight(opts[j])
            hull.insert(
                Line(slope=opts[j].p_static * w, intercept=opts[j].e_dyn * w, payload=opts[j])
            )
            j += 1
        line = hull.query_idx(qi) if use_lichao else hull.query(T)
        if line is not None:
            out[i] = (line.at(T), line.payload)
    return out


# ---------------------------------------------------------------------------
# Vectorized O((M+Q) log M) hull sweep (the "true" Algorithm 1, batched)
# ---------------------------------------------------------------------------


def _hull_of(slope: torch.Tensor, icept: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lower-envelope hull of a block of lines: (slopes, intercepts,
    reversed breakpoints).  Monotone-chain build over slope-sorted lines
    using the same cross-multiplied dominance predicate as
    DynamicLowerHull._bad, so degenerate cases resolve identically.  The
    sort runs on the device (two stable sorts: intercept, then slope —
    NumPy's lexsort); the chain walk is sequential and runs on host
    floats, which compute the predicate with the same float64 bits."""
    o = torch.sort(icept, stable=True).indices
    o = o[torch.sort(slope[o], stable=True).indices]
    s, c = slope[o], icept[o]
    sl, cl = s.tolist(), c.tolist()
    keep: list[int] = []
    for j in range(len(sl)):
        if keep and sl[keep[-1]] == sl[j]:
            continue  # equal slope: lower intercept won
        while len(keep) >= 2:
            i1, i2 = keep[-2], keep[-1]
            if (cl[j] - cl[i1]) * (sl[i2] - sl[i1]) <= (cl[i2] - cl[i1]) * (sl[j] - sl[i1]):
                keep.pop()  # middle line everywhere dominated
            else:
                break
        keep.append(j)
    k = torch.tensor(keep, dtype=torch.int64, device=s.device)
    hs, hc = s[k], c[k]
    # Line i beats line i+1 for T >= bx[i]; hull validity makes bx
    # decreasing in i, so store it reversed (ascending) for searchsorted.
    bxr = ((hc[:-1] - hc[1:]) / (hs[1:] - hs[:-1])).flip(0)
    return hs, hc, bxr


def _hull_eval(hs: torch.Tensor, hc: torch.Tensor, bxr: torch.Tensor,
               T: torch.Tensor) -> torch.Tensor:
    """Envelope minimum of a prebuilt hull at each query T (vectorized
    binary search over breakpoints; the ±1 neighbors are evaluated too so
    breakpoint rounding can never miss the true minimum line)."""
    n = hs.numel()
    if n == 1:
        return hs[0] * T + hc[0]
    idx = (n - 1) - torch.searchsorted(bxr, T, right=True)
    lo = torch.clamp_min(idx - 1, 0)
    hi = torch.clamp_max(idx + 1, n - 1)
    return torch.minimum(torch.minimum(hs[idx] * T + hc[idx], hs[lo] * T + hc[lo]),
                         hs[hi] * T + hc[hi])


def stage_envelope_sweep(
    t_cmp: torch.Tensor, slope: torch.Tensor, icept: torch.Tensor, latencies
) -> torch.Tensor:
    """min over {j : t_cmp_j <= T} of (slope_j*T + icept_j), for every T
    of an ascending latency grid — values only, O((M+Q) log M), on the
    columns' device.

    Options sorted by activation threshold make each query's active set a
    prefix; a prefix [0, k) decomposes into <= log2(M) canonical
    power-of-two blocks (Fenwick ranges), each with a lazily-built static
    hull, queried by vectorized breakpoint binary search.  Total distinct
    blocks across all prefixes is < 2M, so hull construction is
    O(M log M) and the query sweep O(Q log M) — the asymptotics of paper
    Algorithm 1, with the Q-side fully batched.
    """
    lat = torch.as_tensor(latencies, dtype=F64, device=t_cmp.device)
    out = torch.full((lat.numel(),), math.inf, dtype=F64, device=lat.device)
    if t_cmp.numel() == 0 or lat.numel() == 0:
        return out
    order = torch.sort(t_cmp, stable=True).indices
    ts, ss, cs = t_cmp[order], slope[order], icept[order]
    ks = torch.searchsorted(ts, lat, right=True).tolist()  # active prefix per query

    hulls: dict[tuple[int, int], tuple] = {}

    def block(start: int, size: int) -> tuple:
        h = hulls.get((start, size))
        if h is None:
            h = hulls[(start, size)] = _hull_of(ss[start : start + size], cs[start : start + size])
        return h

    q = 0
    while q < len(ks):
        k = ks[q]
        end = q + 1
        while end < len(ks) and ks[end] == k:
            end += 1
        if k > 0:
            T = lat[q:end]
            acc = torch.full((T.numel(),), math.inf, dtype=F64, device=T.device)
            pos, rem = 0, k
            while rem:
                size = 1 << (rem.bit_length() - 1)
                acc = torch.minimum(acc, _hull_eval(*block(pos, size), T))
                pos += size
                rem -= size
            out[q:end] = acc
        q = end
    return out


def stage_envelope_bruteforce(options, latencies, cost_weight=lambda o: 1.0):
    """O(M*Q) reference used by the property tests."""
    out = []
    for T in latencies:
        best, arg = math.inf, None
        for o in options:
            if o.t_cmp <= T:
                v = cost_weight(o) * (o.e_dyn + o.p_static * T)
                if v < best:
                    best, arg = v, o
        out.append((best, arg))
    return out


# ---------------------------------------------------------------------------
# Pipeline solve (the full Layer-3 of the framework)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PipelineSolution:
    objective: str
    value: float  # objective value (lower is better)
    T: float  # per-sample initiation interval (s)
    energy_per_sample: float  # J
    delay_e2e: float  # s (P * T, balanced pipeline)
    hw_cost_usd: float
    throughput: float  # samples/s
    stages: list[StageOption]

    def metrics(self) -> dict[str, float]:
        e, d, c = self.energy_per_sample, self.delay_e2e, self.hw_cost_usd
        # cost metrics use the solver's per-stage decomposition
        # sum_s E_s*$_s (paper §4.3.3 "multiply by the cost factor"),
        # keeping reported numbers consistent with optimized ones.
        ec = sum((o.e_dyn + o.p_static * self.T) * o.hw_cost_usd for o in self.stages)
        return {
            "energy": e,
            "edp": e * d,
            "energy_cost": ec,
            "edp_cost": ec * d,
            "latency_e2e": d,
            "throughput": self.throughput,
            "hw_cost_usd": c,
            "T": self.T,
        }

    def to_dict(self) -> dict:
        return {
            "objective": self.objective,
            "value": self.value,
            "T": self.T,
            "energy_per_sample": self.energy_per_sample,
            "delay_e2e": self.delay_e2e,
            "hw_cost_usd": self.hw_cost_usd,
            "throughput": self.throughput,
            "stages": [s.to_dict() for s in self.stages],
        }

    @staticmethod
    def from_dict(d: dict) -> "PipelineSolution":
        return PipelineSolution(
            objective=d["objective"],
            value=d["value"],
            T=d["T"],
            energy_per_sample=d["energy_per_sample"],
            delay_e2e=d["delay_e2e"],
            hw_cost_usd=d["hw_cost_usd"],
            throughput=d["throughput"],
            stages=[StageOption.from_dict(s) for s in d["stages"]],
        )


def _cost_weight_fn(objective: str) -> Callable[[StageOption], float]:
    if objective.endswith("_cost"):
        # Per-stage cost factor keeps the function affine and the sum
        # separable (paper §4.3.3: "multiply ... by the cost factor").
        return lambda o: max(o.hw_cost_usd, 1e-9)
    return lambda o: 1.0


def _option_columns(
    opts: Sequence[StageOption], device: torch.device | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(t_cmp, e_dyn, p_static, hw_cost) columns: an option set's own (on
    its device), or a plain list's built on `device` (the CPU when None:
    its options are host objects)."""
    if isinstance(opts, StageOptionSet):
        return opts.columns()
    vals = torch.tensor(
        [[o.t_cmp for o in opts], [o.e_dyn for o in opts],
         [o.p_static for o in opts], [o.hw_cost_usd for o in opts]],
        dtype=F64, device=device).reshape(4, len(opts))
    return tuple(vals.unbind(0))


# Per-stage (kept options x latencies) cell count above which the dense
# masked-matrix sweep switches to the O((M+Q) log M) hull sweep.  The
# reference measured the crossover at ~1e7 cells on the CPU and switches
# at 2e6 cells (16 MB of float64) to bound memory too; the port keeps the
# threshold so both packages take the same branch for the same input.
HULLVEC_MIN_CELLS = 2_000_000


def _stage_cols(
    stage_options: Sequence[Sequence[StageOption]], weighted: bool,
    device: torch.device,
) -> list[tuple] | None:
    """Per-stage pruned (t_cmp, slope, intercept, original_index) columns
    on `device`, or None when any stage has no options (infeasible
    pipeline)."""
    cols: list[tuple] = []
    for opts in stage_options:
        if isinstance(opts, StageOptionSet):
            if len(opts) == 0:
                return None
            cols.append(tuple(x.to(device) for x in opts.pruned(weighted)))
            continue
        t_cmp, e_dyn, p_static, hw = _option_columns(opts, device)
        if t_cmp.numel() == 0:
            return None
        w = torch.clamp_min(hw, 1e-9) if weighted else 1.0
        slope, icept = p_static * w, e_dyn * w
        idx = torch.nonzero(envelope_keep_mask(t_cmp, slope, icept)).flatten()
        cols.append((t_cmp[idx], slope[idx], icept[idx], idx))
    return cols


def _lengths(lengths: Sequence[int], device: torch.device) -> torch.Tensor:
    return torch.tensor(lengths, dtype=torch.int64, device=device)


def _segment_min(vals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """NumPy's `minimum.reduceat` over contiguous, non-empty segments of
    the given lengths along dim 0.  Exact on every device: min does not
    depend on the order it is taken in."""
    return torch.segment_reduce(vals, "min", lengths=lengths, axis=0, unsafe=True)


def _first_winner(t_cmp: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Index of the option attaining min(v) (exact float equality), the
    smallest t_cmp among those, and the lowest index among equal t_cmp —
    the hull engine's tie-break — as a 0-dim device tensor."""
    elig = v == v.min()
    tmin = torch.where(elig, t_cmp, math.inf).min()
    good = elig & (t_cmp == tmin)
    n = t_cmp.numel()
    return torch.where(good, torch.arange(n, device=v.device), n).min()


def _materialize(stage_options: Sequence[Sequence[StageOption]],
                 picks: Sequence[int], device: torch.device) -> list[StageOption]:
    """The chosen option of every stage, with one device-to-host copy of
    the column values of all the column-built option sets among them."""
    out: list[StageOption | None] = [None] * len(picks)
    views, where = [], []
    for k, (opts, i) in enumerate(zip(stage_options, picks)):
        if isinstance(opts, StageOptionSet) and opts.columnar:
            views.append(opts.row_view(i).to(device))
            where.append(k)
        else:
            out[k] = opts[i]
    if views:
        for k, vals in zip(where, torch.cat(views).tolist()):
            out[k] = stage_options[k].option_from(picks[k], vals)
    return out


def _build_solution(
    stage_options: Sequence[Sequence[StageOption]],
    cols: list[tuple],
    lat: list[float],
    total: torch.Tensor,
    objective: str,
    P: int,
) -> PipelineSolution | None:
    """argmin over the summed grid + second pass recovering each stage's
    winner at the winning T only.  Exact-tie break mirrors the hull
    engine: duplicate lines keep the first inserted, and insertion order
    is ascending t_cmp (stable)."""
    best_i, best_v = torch.stack([total.argmin().to(F64), total.min()]).tolist()
    best_i = int(best_i)
    if not math.isfinite(best_v):
        return None
    best_T = lat[best_i]
    wins = []
    for t_cmp, slope, icept, idx in cols:
        v = slope * best_T + icept
        v = v.masked_fill(t_cmp > best_T, math.inf)
        wins.append(idx[_first_winner(t_cmp, v)])
    best_stages = _materialize(stage_options, torch.stack(wins).tolist(),
                               total.device)
    e = sum(o.e_dyn + o.p_static * best_T for o in best_stages)
    cost = sum(o.hw_cost_usd for o in best_stages)
    return PipelineSolution(
        objective=objective,
        value=best_v,
        T=best_T,
        energy_per_sample=e,
        delay_e2e=best_T * P,
        hw_cost_usd=cost,
        throughput=1.0 / best_T,
        stages=best_stages,
    )


def _solve_pipeline_tensor(
    stage_options: Sequence[Sequence[StageOption]],
    lat: list[float],
    objective: str,
    P: int,
    device: torch.device,
    force_sweep: bool = False,
) -> PipelineSolution | None:
    """Vectorized iso-latency sweep on `device`.  Per stage, envelope
    values over the grid come from either a masked (options x latencies)
    dense tensor min or, above HULLVEC_MIN_CELLS (or with
    engine="hullvec"), the O((M+Q) log M) prefix-block hull sweep.
    Values match the hull engine (same slope/intercept formulation) to
    the last bit; ties between exactly-equal options may pick a different
    argmin."""
    latv = torch.tensor(lat, dtype=F64, device=device)
    weighted = objective.endswith("_cost")
    cols = _stage_cols(stage_options, weighted, device)
    if cols is None:
        return None
    mins_rows: list[torch.Tensor | None] = [None] * len(cols)
    dense = [
        i
        for i, c in enumerate(cols)
        if not force_sweep and c[0].numel() * latv.numel() < HULLVEC_MIN_CELLS
    ]
    for i, c in enumerate(cols):
        if i not in dense:
            mins_rows[i] = stage_envelope_sweep(c[0], c[1], c[2], latv)
    if dense:
        # One (sum-of-options x latencies) matrix for the dense stages;
        # per-stage minima via segmented reduction.
        tc = torch.cat([cols[i][0] for i in dense])
        slope = torch.cat([cols[i][1] for i in dense])
        icept = torch.cat([cols[i][2] for i in dense])
        vals = slope[:, None] * latv[None, :]
        vals += icept[:, None]
        vals.masked_fill_(tc[:, None] > latv[None, :], math.inf)
        mins = _segment_min(vals, _lengths([cols[i][0].numel() for i in dense], device))
        for i, row in zip(dense, mins):
            mins_rows[i] = row
    total = torch.zeros(len(lat), dtype=F64, device=device)
    for row in mins_rows:  # per-stage add order preserved
        total += row
    if objective in ("edp", "edp_cost"):
        total = total * (latv * P)
    return _build_solution(stage_options, cols, lat, total, objective, P)


def solve_pipeline(
    stage_options: Sequence[Sequence[StageOption]],
    latencies: Sequence[float],
    objective: str = "energy",
    max_interval: float | None = None,
    max_e2e: float | None = None,
    n_stages: int | None = None,
    engine: str = "auto",
    device: str | torch.device | None = None,
) -> PipelineSolution | None:
    """Iso-latency with modified convex hull trick over a whole pipeline.

    objective: energy | edp | energy_cost | edp_cost.
    max_interval: TPOT-style bound on T; max_e2e: TTFT/E2E bound on P*T.
    n_stages: physical stage count (sum of repeats) when stage groups are
    compressed; defaults to len(stage_options).
    engine: auto (the vectorized tensor sweep when the evaluation engine
    is on, else hull) | numpy (the dense tensor sweep; the reference's
    name) | hullvec (the O((M+Q) log M) hull sweep forced for every
    stage) | hull | lichao (host Python).
    device: where the tensor sweeps run (the card unless the caller names
    another).
    """
    assert objective in ("energy", "edp", "energy_cost", "edp_cost")
    dev = resolve_device(device)
    P = n_stages if n_stages is not None else len(stage_options)
    lat = sorted(set(latencies))
    if max_interval is not None:
        lat = [t for t in lat if t <= max_interval]
    if max_e2e is not None:
        lat = [t for t in lat if t * P <= max_e2e]
    if not lat or P == 0:
        return None

    if engine == "auto":
        engine = "numpy" if engine_enabled() else "hull"
    if engine in ("numpy", "hullvec"):
        return _solve_pipeline_tensor(
            stage_options, lat, objective, P, dev, force_sweep=engine == "hullvec"
        )

    w = _cost_weight_fn(objective)
    envs = [stage_envelope(opts, lat, cost_weight=w, engine=engine) for opts in stage_options]

    best_val, best_T, best_stages = math.inf, None, None
    for i, T in enumerate(lat):
        val, stages = 0.0, []
        ok = True
        for env in envs:
            v, o = env[i]
            if o is None:
                ok = False
                break
            val += v
            stages.append(o)
        if not ok:
            continue
        if objective in ("edp", "edp_cost"):
            val *= T * P  # ObjFactor (Algorithm 1 l.23)
        if val < best_val:
            best_val, best_T, best_stages = val, T, stages

    if best_stages is None:
        return None
    e = sum(o.e_dyn + o.p_static * best_T for o in best_stages)
    cost = sum(o.hw_cost_usd for o in best_stages)
    return PipelineSolution(
        objective=objective,
        value=best_val,
        T=best_T,
        energy_per_sample=e,
        delay_e2e=best_T * P,
        hw_cost_usd=cost,
        throughput=1.0 / best_T,
        stages=best_stages,
    )


@dataclasses.dataclass
class PipelineJob:
    """One genome's Layer-3 solve, as an element of a generation batch:
    the per-stage option sets, the latency grid, and the constraints that
    `solve_pipeline` would receive for that genome."""

    stage_options: Sequence[Sequence[StageOption]]
    latencies: Sequence[float]
    max_interval: float | None = None
    max_e2e: float | None = None
    n_stages: int | None = None


# Upper bound on dense cells materialized by one flat generation sweep;
# batches beyond it are processed in chunks (bounds peak memory at
# ~3 full-size float64 temporaries).
BATCH_MAX_CELLS = 8_000_000


def _flat(blocks: list[tuple[int, int]], prepared: list, k: int) -> torch.Tensor:
    return torch.cat([prepared[pi][3][si][k] for pi, si in blocks])


def _batch_dense_rows(
    blocks: list[tuple[int, int]], prepared: list,
    out_rows: dict[tuple[int, int], torch.Tensor], device: torch.device,
) -> None:
    """Evaluate every dense (job, stage) block of a generation in ONE
    segmented sweep.

    Jobs have ragged grids, so the per-job grids are packed into a
    (jobs x max_grid) matrix (padded columns are never read back) and
    every option row gathers its job's grid row: one multiply, one add,
    one mask over the stacked (all options x max_grid) matrix, then a
    single segmented minimum with one segment per (job, stage) block.
    Each cell computes slope*T then +intercept — the exact op sequence of
    the per-genome dense sweep — so the resulting rows are bit-identical
    to per-genome `_solve_pipeline_tensor` calls.
    """
    M = [prepared[pi][3][si][0].numel() for pi, si in blocks]
    t_all, s_all, c_all = (_flat(blocks, prepared, k) for k in range(3))
    job_ids = sorted({pi for pi, _ in blocks})
    job_row = {pi: r for r, pi in enumerate(job_ids)}
    max_q = max(len(prepared[pi][1]) for pi in job_ids)
    # Padded per-job grid matrix, built on the host from the grids' own
    # floats and copied once; the pad value only fills cells that are
    # sliced away below, so its value is irrelevant (0 keeps it finite).
    lat_pad = np.zeros((len(job_ids), max_q))
    for pi in job_ids:
        lat_pad[job_row[pi], : len(prepared[pi][1])] = prepared[pi][1]
    row_of_option = np.repeat(np.array([job_row[pi] for pi, _ in blocks]), M)
    T = torch.from_numpy(lat_pad).to(device)[
        torch.from_numpy(row_of_option).to(device)]  # (total options x max_q)
    vals = s_all[:, None] * T
    vals += c_all[:, None]
    vals.masked_fill_(t_all[:, None] > T, math.inf)
    mins = _segment_min(vals, _lengths(M, device))
    for b, (pi, si) in enumerate(blocks):
        out_rows[(pi, si)] = mins[b, : len(prepared[pi][1])]


def _batch_recover(
    blocks: list[tuple[int, int]], prepared: list, best_T: dict[int, float],
    device: torch.device,
) -> dict[tuple[int, int], int]:
    """Batched second pass: for every (job, stage) block, the original
    index (into the stage's option set) of the winning option at the
    job's winning T — one flat segmented computation and one host copy
    replacing the per-job recovery loop.

    The tie-break is the hull engine's, replicated exactly: among
    options attaining the envelope minimum (exact float equality), the
    smallest t_cmp wins, and among equal t_cmp the lowest index (first
    inserted) wins."""
    M = [prepared[pi][3][si][0].numel() for pi, si in blocks]
    n = sum(M)
    lengths = _lengths(M, device)
    seg_h = np.repeat(np.arange(len(M)), M)
    seg = torch.from_numpy(seg_h).to(device)
    # The block-local index of each option, as float64 (exact below
    # 2**53) for the segmented minimum; n marks an option that lost.
    loc = torch.from_numpy(np.arange(n) - (np.cumsum(M) - M)[seg_h]).to(device, F64)
    t_all, s_all, c_all, g_all = (_flat(blocks, prepared, k) for k in range(4))
    Tb = torch.from_numpy(np.repeat(np.array([best_T[pi] for pi, _ in blocks]), M)).to(device)
    v = s_all * Tb
    v += c_all
    v.masked_fill_(t_all > Tb, math.inf)
    vmin = _segment_min(v, lengths)
    elig = v == vmin[seg]
    tkey = torch.where(elig, t_all, math.inf)
    tmin = _segment_min(tkey, lengths)
    good = elig & (t_all == tmin[seg])
    win = _segment_min(torch.where(good, loc, float(n)), lengths).to(torch.int64)
    starts = torch.from_numpy(np.cumsum(M) - M).to(device)
    return dict(zip(blocks, g_all[starts + win].tolist()))


def solve_pipeline_batch(
    jobs: Sequence[PipelineJob], objective: str = "energy", engine: str = "auto",
    device: str | torch.device | None = None, batch_solve: bool = True,
) -> list[PipelineSolution | None]:
    """Generation-batched `solve_pipeline`: every job's per-stage
    envelope columns are stacked into one ragged flat tensor set on
    `device` and the iso-latency grids of the whole batch are swept
    together with segmented minimum reductions; per-job winning stages
    are recovered in a single second pass at each job's winning T, and
    only the winners are copied to the host.

    Returns one `PipelineSolution | None` per job, aligned with `jobs`,
    bit-identical (values, T, stage configs, tie-breaks) to calling
    `solve_pipeline` per job.  Stages whose (options x latencies) cell
    count crosses HULLVEC_MIN_CELLS still use the O((M+Q) log M) hull
    sweep, exactly as the per-genome path would.  `batch_solve=False`
    (or a non-tensor engine) falls back to the per-job loop.
    """
    assert objective in ("energy", "edp", "energy_cost", "edp_cost")
    dev = resolve_device(device)
    per_genome = False
    if engine == "auto":
        if not engine_enabled():
            engine = "hull"
        elif not batch_solve:
            engine = "numpy"  # per-genome loop, vectorized path
            per_genome = True
        else:
            engine = "numpy"
    if per_genome or engine not in ("numpy", "hullvec"):
        return [
            solve_pipeline(
                j.stage_options,
                j.latencies,
                objective=objective,
                max_interval=j.max_interval,
                max_e2e=j.max_e2e,
                n_stages=j.n_stages,
                engine=engine,
                device=dev,
            )
            for j in jobs
        ]
    force_sweep = engine == "hullvec"
    weighted = objective.endswith("_cost")

    # Per-job preprocessing, mirroring solve_pipeline exactly:
    # (latv, lat list, P, cols) or None for infeasible jobs.
    prepared: list[tuple | None] = []
    for j in jobs:
        P = j.n_stages if j.n_stages is not None else len(j.stage_options)
        lat = sorted(set(j.latencies))
        if j.max_interval is not None:
            lat = [t for t in lat if t <= j.max_interval]
        if j.max_e2e is not None:
            lat = [t for t in lat if t * P <= j.max_e2e]
        if not lat or P == 0:
            prepared.append(None)
            continue
        cols = _stage_cols(j.stage_options, weighted, dev)
        if cols is None:
            prepared.append(None)
            continue
        prepared.append((torch.tensor(lat, dtype=F64, device=dev), lat, P, cols))

    # Plan: dense blocks go to the flat batched sweep (chunked to bound
    # memory — the chunk's footprint is (sum of option counts) x (max
    # grid length), since shorter grids are padded up to the longest in
    # the chunk); oversized stages use the per-stage hull sweep.
    rows: dict[tuple[int, int], torch.Tensor] = {}
    chunk: list[tuple[int, int]] = []
    chunk_m = 0
    chunk_q = 0
    for pi, prep in enumerate(prepared):
        if prep is None:
            continue
        latv, _, _, cols = prep
        for si, c in enumerate(cols):
            m, q = c[0].numel(), latv.numel()
            if force_sweep or m * q >= HULLVEC_MIN_CELLS:
                rows[(pi, si)] = stage_envelope_sweep(c[0], c[1], c[2], latv)
                continue
            if chunk and (chunk_m + m) * max(chunk_q, q) > BATCH_MAX_CELLS:
                _batch_dense_rows(chunk, prepared, rows, dev)
                chunk, chunk_m, chunk_q = [], 0, 0
            chunk.append((pi, si))
            chunk_m += m
            chunk_q = max(chunk_q, q)
    if chunk:
        _batch_dense_rows(chunk, prepared, rows, dev)

    # Per-job totals (cheap vector ops per job); every job's first argmin
    # and minimum come to the host in one copy, and the per-stage winner
    # recovery across all jobs is batched below.
    totals: dict[int, torch.Tensor] = {}
    for pi, prep in enumerate(prepared):
        if prep is None:
            continue
        latv, lat, P, cols = prep
        total = torch.zeros(len(lat), dtype=F64, device=dev)
        for si in range(len(cols)):  # per-stage add order preserved
            total += rows[(pi, si)]
        if objective in ("edp", "edp_cost"):
            total = total * (latv * P)
        totals[pi] = total
    best_val: dict[int, float] = {}
    best_T: dict[int, float] = {}
    if totals:
        picks = torch.stack([torch.stack([t.argmin().to(F64), t.min()])
                             for t in totals.values()]).tolist()
        for pi, (i, v) in zip(totals, picks):
            if math.isfinite(v):
                best_val[pi] = v
                best_T[pi] = prepared[pi][1][int(i)]

    rec = [(pi, si) for pi in best_T for si in range(len(prepared[pi][3]))]
    winners = _batch_recover(rec, prepared, best_T, dev) if rec else {}
    chosen = _materialize([jobs[pi].stage_options[si] for pi, si in rec],
                          [winners[b] for b in rec], dev)
    stages_of: dict[int, list[StageOption]] = {}
    for (pi, _), o in zip(rec, chosen):
        stages_of.setdefault(pi, []).append(o)

    out: list[PipelineSolution | None] = []
    for pi, prep in enumerate(prepared):
        if prep is None or pi not in best_T:
            out.append(None)
            continue
        P = prep[2]
        T = best_T[pi]
        stages = stages_of[pi]
        e = sum(o.e_dyn + o.p_static * T for o in stages)
        cost = sum(o.hw_cost_usd for o in stages)
        out.append(
            PipelineSolution(
                objective=objective,
                value=best_val[pi],
                T=T,
                energy_per_sample=e,
                delay_e2e=T * P,
                hw_cost_usd=cost,
                throughput=1.0 / T,
                stages=stages,
            )
        )
    return out


def solve_pipeline_bruteforce(
    stage_options, latencies, objective="energy", max_interval=None, max_e2e=None, n_stages=None
):
    """Exponential-in-nothing reference: per-T exhaustive stage scan."""
    P = n_stages if n_stages is not None else len(stage_options)
    lat = sorted(set(latencies))
    if max_interval is not None:
        lat = [t for t in lat if t <= max_interval]
    if max_e2e is not None:
        lat = [t for t in lat if t * P <= max_e2e]
    w = _cost_weight_fn(objective)
    best = None
    for T in lat:
        val, stages, ok = 0.0, [], True
        for opts in stage_options:
            b, arg = math.inf, None
            for o in opts:
                if o.t_cmp <= T:
                    v = w(o) * (o.e_dyn + o.p_static * T)
                    if v < b:
                        b, arg = v, o
            if arg is None:
                ok = False
                break
            val += b
            stages.append(arg)
        if not ok:
            continue
        if objective in ("edp", "edp_cost"):
            val *= T * P
        if best is None or val < best.value:
            e = sum(o.e_dyn + o.p_static * T for o in stages)
            cost = sum(o.hw_cost_usd for o in stages)
            best = PipelineSolution(
                objective=objective,
                value=val,
                T=T,
                energy_per_sample=e,
                delay_e2e=T * P,
                hw_cost_usd=cost,
                throughput=1.0 / T,
                stages=stages,
            )
    return best


# Latency grids memoized per (n, option-set uids): the grid depends only
# on the option sets, and distinct genomes routinely decode to the same
# cached StageOptionSets, so batched and scalar genome evaluations share
# one grid computation per distinct fusion plan.  Keyed by the sets'
# process-unique uid tokens (never reused, unlike id()), FIFO-bounded.
# Single-writer: only the solver loop of one process fills it.
_GRID_CACHE: dict[tuple, list[float]] = {}
_GRID_CACHE_MAX = 65536


def clear_grid_cache() -> None:
    _GRID_CACHE.clear()


def default_latency_grid(
    stage_options: Sequence[Sequence[StageOption]], n: int = 64
) -> list[float]:
    """Geometric grid spanning [min feasible T, max useful T].  Includes
    every stage's t_cmp values (the only points where envelopes change
    shape matter beyond grid resolution).  Computed on the option sets'
    device; the extremes, each stage's minimum and the first 256
    activation points come to the host in one copy.  Memoized per
    option-set key when every stage is a StageOptionSet."""
    key = None
    if stage_options and all(isinstance(o, StageOptionSet) for o in stage_options):
        key = (n, *(o.uid for o in stage_options))
        hit = _GRID_CACHE.get(key)
        if hit is not None:
            return list(hit)
    per_stage = [_option_columns(opts)[0] for opts in stage_options]
    tc = torch.cat(per_stage) if per_stage else torch.empty(0, dtype=F64)
    head = torch.cat([torch.stack([tc.min(), tc.max()]),
                      torch.stack([c.min() for c in per_stage]),
                      tc[:256]]).tolist()
    lo, hi = head[0], head[1]
    hi = max(hi, lo * 4)
    grid = {lo * (hi / lo) ** (i / (n - 1)) for i in range(n)}
    # All bottleneck candidates: the max over stages of per-stage t_cmp's.
    grid.update(head[2 : 2 + len(per_stage)])
    grid.update(head[2 + len(per_stage) :])
    out = sorted(grid)
    if key is not None:
        if len(_GRID_CACHE) >= _GRID_CACHE_MAX:
            _GRID_CACHE.pop(next(iter(_GRID_CACHE)))
        _GRID_CACHE[key] = out
        return list(out)
    return out
