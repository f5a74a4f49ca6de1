"""The traced sub-window's attribution (`harness.trace`): device time
booked to the `cb.*` ranges open at each activity's launch, an activity
with no recorded launch booked with the one before it on the stream, and
the wrappers' markers closing a range where its call returns."""
import contextlib
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from harness import trace


class Ev:
    """One profiler event, as `parse` reads it."""

    def __init__(self, dev, start, end, name, corr=0, linked=0, annotation=False):
        self._d = dict(dev=dev, start=start, end=end, name=name, corr=corr, linked=linked,
                       annotation=annotation)

    def device_type(self):
        return self._d["dev"]

    def start_ns(self):
        return self._d["start"]

    def end_ns(self):
        return self._d["end"]

    def name(self):
        return self._d["name"]

    def correlation_id(self):
        return self._d["corr"]

    def linked_correlation_id(self):
        return self._d["linked"]

    def is_user_annotation(self):
        return self._d["annotation"]


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _events(end_marker: bool):
    """A decode step [100, 1000] holding a `fused_mlp` call [200, 400]:
    a marker launched inside the call, one after it (if `end_marker`),
    then a matmul; on the device each marker is followed by a kernel
    whose launch was not recorded."""
    ev = [Ev(CPU, 100, 1000, "cb.decode", corr=1, annotation=True),
          Ev(CPU, 200, 400, "cb.fused_mlp", corr=2, annotation=True),
          Ev(CPU, 210, 220, "aten::zero_", corr=11),
          Ev(CPU, 215, 218, "cudaLaunchKernel", corr=101, linked=11),
          Ev(CPU, 500, 520, "aten::mm", corr=13),
          Ev(CPU, 505, 510, "cudaLaunchKernel", corr=103, linked=13),
          Ev(CUDA, 1000, 1001, "fill", corr=101, linked=11),
          Ev(CUDA, 1001, 1100, "mlp_tile", corr=0),
          Ev(CUDA, 1101, 1200, "library_kernel", corr=0),
          Ev(CUDA, 1200, 1300, "gemm", corr=103, linked=13)]
    if end_marker:
        ev += [Ev(CPU, 410, 420, "aten::zero_", corr=12),
               Ev(CPU, 415, 418, "cudaLaunchKernel", corr=102, linked=12),
               Ev(CUDA, 1100, 1101, "fill", corr=102, linked=12)]
    return ev


def test_unlaunched_kernel_after_a_range_leaves_it():
    res = trace.parse(_prof(_events(end_marker=True)), 1e-6)
    assert res.device_s["fused_mlp"] == pytest.approx(100e-9)         # the marker and the tile
    assert res.device_s["fused_mlp@decode"] == pytest.approx(100e-9)
    assert res.device_s["decode"] == pytest.approx(300e-9)            # everything
    assert res.busy_s == pytest.approx(300e-9)
    assert res.attributed == pytest.approx(102 / 300)
    assert dict(res.device_ops)["library_kernel"] == pytest.approx(99e-9)


def test_without_the_end_marker_the_range_would_take_the_next_kernel():
    res = trace.parse(_prof(_events(end_marker=False)), 1e-6)
    assert res.device_s["fused_mlp"] == pytest.approx(199e-9)


def test_a_host_event_without_correlation_claims_no_kernel():
    """The profiler's own host events (a buffer flush) carry correlation 0,
    as do kernels with no recorded launch: the two are not linked."""
    ev = _events(end_marker=True) + [Ev(CPU, 600, 700, "Buffer Flush", corr=0)]
    res = trace.parse(_prof(ev), 1e-6)
    assert res.device_s["fused_mlp"] == pytest.approx(100e-9)
    assert res.attributed == pytest.approx(102 / 300)
    assert not any("Buffer Flush" in n for n, _ in res.idle_gaps)


def test_idle_gaps_are_named_by_the_launch_ending_them():
    ev = _events(end_marker=True)
    ev[-4] = Ev(CUDA, 1250, 1300, "gemm", corr=103, linked=13)      # 50 ns idle before it
    res = trace.parse(_prof(ev), 1e-6)
    assert dict(res.idle_gaps)["cb.decode:aten::mm"] == pytest.approx(50e-9)
    assert res.busy_s == pytest.approx(250e-9)


def test_wrappers_mark_inside_and_after_each_range(monkeypatch):
    from repro_torch.kernels.fused_mlp import ops as mlp_ops

    log, open_ = [], []

    @contextlib.contextmanager
    def rf(name):
        open_.append(name)
        try:
            yield
        finally:
            open_.pop()

    def fake_mlp(x, wg, wi, wo, *, swiglu=True):
        log.append(("mlp", tuple(open_)))
        return x

    def decode(params, next_token, active):
        log.append(("decode", tuple(open_)))
        return mlp_ops.fused_mlp(params, params, params, params)

    monkeypatch.setattr(mlp_ops, "fused_mlp", fake_mlp)
    state = SimpleNamespace(prefill=lambda *a, **k: None, decode=decode)
    wrap = trace._Wrap(SimpleNamespace(state=state, device="cpu"), rf)
    wrap.mark = SimpleNamespace(zero_=lambda: log.append(("mark", tuple(open_))))
    import torch

    try:
        state.decode(torch.zeros(2, 4), None, [0])
    finally:
        wrap.undo()
    assert log == [("mark", ("cb.decode",)), ("decode", ("cb.decode",)),
                   ("mark", ("cb.decode", "cb.fused_mlp")),
                   ("mlp", ("cb.decode", "cb.fused_mlp")),
                   ("mark", ("cb.decode",)), ("mark", ())]
    assert mlp_ops.fused_mlp is fake_mlp and wrap.calls["decode"] == 1
