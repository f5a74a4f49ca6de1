"""The traced sub-window of a `--trace 1` run.

After the measured window closes, the loop runs on for a few seconds
under `torch.profiler` (CPU and CUDA activity, kept in memory, never
written out), with the program's calls wrapped from outside, in this
sub-window only:

* `engine.state.prefill` and `engine.state.decode` in `cb.prefill` /
  `cb.decode` ranges (a prefill's prompt tokens and the calls counted);
* `moe_mlp` and `fused_mlp` (`repro_torch.kernels.*.ops`) in `cb.moe_mlp`
  / `cb.fused_mlp` ranges, with each call's shapes and, for `moe_mlp`,
  the non-empty capacity rows of each expert (a reduction on the device,
  launched outside the range and read after the sub-window).

Each device activity (kernel, copy, set) is attributed through its
correlation to the host call that launched it, and through that call's
time to the `cb.*` ranges open around it (`parse`).  The profiler
records no launch for some kernels of the program's own libraries; such
an activity takes the ranges of the activity before it on the stream.
So each wrapper launches a one-element fill (a marker the profiler links
to its launch) first inside its range and again right after the call
returns, outside it: attribution opens and closes with the range.  Busy
time is the union of the device activities; an idle gap between two is
named by the range and op that launched the activity ending it.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict


@dataclasses.dataclass
class TraceResult:
    window_s: float = 0.0
    busy_s: float = 0.0
    device_s: dict = dataclasses.field(default_factory=dict)   # range -> s
    calls: dict = dataclasses.field(default_factory=dict)      # "decode", "prefill" -> n
    prefill_tokens: int = 0
    moe_calls: list = dataclasses.field(default_factory=list)   # (rows, d, f, itemsize)
    mlp_calls: list = dataclasses.field(default_factory=list)   # (n, d, f, itemsize, phase)
    device_ops: list = dataclasses.field(default_factory=list)
    idle_gaps: list = dataclasses.field(default_factory=list)
    attributed: float = 0.0        # share of device time whose launch was recorded


class _Wrap:
    """The sub-window's wrappers; `undo()` puts the program back."""

    def __init__(self, engine, record_function):
        from repro_torch.kernels.fused_mlp import ops as mlp_ops
        from repro_torch.kernels.moe_mlp import ops as moe_ops

        import torch

        self.rf = record_function
        self.mark = torch.zeros(1, device=engine.device)
        self.phase = "step"
        self.calls = defaultdict(int)
        self.prefill_tokens = 0
        self.moe_rows = []
        self.moe_meta = []
        self.mlp_calls = []
        self._undo = []
        st = engine.state
        self._patch(st, "prefill", self._prefill(st.prefill), instance=True)
        self._patch(st, "decode", self._decode(st.decode), instance=True)
        self._patch(moe_ops, "moe_mlp", self._moe(moe_ops.moe_mlp))
        self._patch(mlp_ops, "fused_mlp", self._mlp(mlp_ops.fused_mlp))

    def _patch(self, obj, name, fn, instance=False):
        old = obj.__dict__.get(name) if instance else getattr(obj, name)
        self._undo.append((obj, name, old, instance))
        setattr(obj, name, fn)

    def undo(self) -> None:
        for obj, name, old, instance in reversed(self._undo):
            if instance and old is None:
                delattr(obj, name)
            else:
                setattr(obj, name, old)

    def _ranged(self, name, fn, *args, **kw):
        """fn(*args, **kw) in the range `name`, a marker launched first
        inside the range and another right after it."""
        try:
            with self.rf(name):
                self.mark.zero_()
                return fn(*args, **kw)
        finally:
            self.mark.zero_()

    def _prefill(self, fn):
        def prefill(params, b, seq, frames=None):
            self.calls["prefill"] += 1
            self.prefill_tokens += len(seq)
            self.phase = "prefill"
            try:
                return self._ranged("cb.prefill", fn, params, b, seq, frames=frames)
            finally:
                self.phase = "step"
        return prefill

    def _decode(self, fn):
        def decode(params, next_token, active):
            self.calls["decode"] += 1
            self.phase = "decode"
            try:
                return self._ranged("cb.decode", fn, params, next_token, active)
            finally:
                self.phase = "step"
        return decode

    def _moe(self, fn):
        def moe_mlp(x, wg, wi, wo, *, swiglu=True):
            self.moe_rows.append((x != 0).any(-1).sum(-1))
            self.moe_meta.append((x.shape[-1], wi.shape[-1], x.element_size()))
            return self._ranged("cb.moe_mlp", fn, x, wg, wi, wo, swiglu=swiglu)
        return moe_mlp

    def _mlp(self, fn):
        def fused_mlp(x, wg, wi, wo, *, swiglu=True):
            d = x.shape[-1]
            self.mlp_calls.append((x.numel() // d, d, wi.shape[-1], x.element_size(), self.phase))
            return self._ranged("cb.fused_mlp", fn, x, wg, wi, wo, swiglu=swiglu)
        return fused_mlp


def _label_starts(annotations, times):
    """{t: names of the cb.* ranges open at host time t}; ranges on one
    thread nest, so a stack holds the open ones."""
    ann = sorted(annotations, key=lambda a: (a[0], -a[1]))
    out, stack, i = {}, [], 0
    for t in sorted(set(times)):
        while i < len(ann) and ann[i][0] <= t:
            while stack and stack[-1][1] <= ann[i][0]:
                stack.pop()
            stack.append(ann[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[t] = tuple(a[2] for a in stack)
    return out


def _keys(labels: tuple) -> list[str]:
    keys = [n.removeprefix("cb.") for n in labels]
    if "fused_mlp" in keys:
        keys.append("fused_mlp@" + ("prefill" if "prefill" in keys else
                                    "decode" if "decode" in keys else "other"))
    return keys


def parse(prof, window_s: float, top: int = 10) -> TraceResult:
    """Device time by range, busy time, heaviest device ops and idle gaps
    of one profiler window.  A device activity's launch is the host's
    launch call with its correlation id, or else the host op it is
    linked to; the `cb.*` ranges open then are its ranges.  An activity
    whose launch the profiler did not record (a kernel of the program's
    own libraries may lack one) takes the ranges of the activity before
    it on the stream: each wrapper launches a linked op first inside its
    range and one right after it.  Id 0 links nothing: host events with no
    correlation (the profiler's own buffer flushes) carry it, and so do
    activities with no recorded launch."""
    from torch.autograd import DeviceType

    ops, launches, ann, dev = {}, {}, [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() == 0:
                if e.correlation_id():
                    ops[e.correlation_id()] = (e.start_ns(), e.name())
                if e.is_user_annotation() and e.name().startswith("cb."):
                    ann.append((e.start_ns(), e.end_ns(), e.name()))
            elif e.correlation_id():
                launches[e.correlation_id()] = (e.start_ns(), e.linked_correlation_id())
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            dev.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id(),
                        e.linked_correlation_id()))
    res = TraceResult(window_s=window_s)
    if not dev:
        return res
    dev.sort()

    def launch(corr, linked):
        """(host time of the launch, the host op's name), or None."""
        if corr and corr in launches:
            t, op = launches[corr]
            return t, ops[op][1] if op in ops else "launch"
        return ops.get(linked) if linked else None

    found = [launch(c, lk) for *_, c, lk in dev]
    labels = _label_starts(ann, [f[0] for f in found if f])
    by_key, by_name, gaps = defaultdict(float), defaultdict(float), defaultdict(float)
    attributed = total = busy = 0.0
    rng, what = (), "loop"
    cur_s, cur_e = dev[0][0], dev[0][0]
    for (s, e, name, _, _), f in zip(dev, found):
        dt = (e - s) / 1e9
        total += dt
        by_name[name[:96]] += dt
        if f:
            attributed += dt
            rng = labels[f[0]]
            what = f"{rng[-1] if rng else 'loop'}:{f[1]}"
        for k in _keys(rng):
            by_key[k] += dt
        if s > cur_e:
            busy += cur_e - cur_s
            gaps[what] += (s - cur_e) / 1e9
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    res.busy_s = busy / 1e9
    res.device_s = dict(by_key)
    res.attributed = attributed / total if total else 0.0
    edge = window_s - (dev[-1][1] - dev[0][0]) / 1e9
    if edge > 0:
        gaps["window edges"] += edge
    res.device_ops = sorted(([n, t] for n, t in by_name.items()), key=lambda r: -r[1])[:top]
    res.idle_gaps = sorted(([n, t] for n, t in gaps.items()), key=lambda r: -r[1])[:top]
    return res


def traced(loop, seconds: float, tries: int = 3, log=print) -> TraceResult:
    """Runs the loop for `seconds` under the profiler with the wrappers in
    place; a window in which the profiler recorded no device activity, or
    none attributed to a decode step, is taken again, up to `tries`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    res = TraceResult()
    for t in range(tries):
        wrap = _Wrap(loop.eng, record_function)
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                loop.run_for(seconds)
                torch.cuda.synchronize()
                window_s = time.monotonic() - t0
        finally:
            wrap.undo()
        res = parse(prof, window_s)
        del prof
        log(f"[chipbench] traced window {t + 1}: {window_s:.3f} s, device busy "
            f"{res.busy_s:.3f} s, {res.attributed:.4f} of device time with its launch "
            f"recorded")
        if res.busy_s > 0 and res.device_s.get("decode", 0) > 0:
            break
    rows = torch.stack(wrap.moe_rows).tolist() if wrap.moe_rows else []
    res.moe_calls = [(r, *m) for r, m in zip(rows, wrap.moe_meta)]
    res.mlp_calls = wrap.mlp_calls
    res.calls = dict(wrap.calls)
    res.prefill_tokens = wrap.prefill_tokens
    return res
