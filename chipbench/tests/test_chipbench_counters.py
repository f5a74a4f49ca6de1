"""The readers of the program's counters and marks (`step_host_ms`,
`queue_wait_p90_ms`): each books what its definition says, and each
reads nothing (None) from a program without them."""
from types import SimpleNamespace

import pytest

from harness.bench import reader

import tiny


def _rec(t_submit, t_admit=None):
    req = SimpleNamespace(t_submit=t_submit)
    if t_admit is not None:
        req.t_admit = t_admit
    return SimpleNamespace(req=req)


PROGRAM = {"stats": {"steps": 4, "step_us": 10_000, "sync_wait_us": 6_000,
                     "decode_steps": 4, "tokens_out": 40, "prefills": 2},
           "recs": [_rec(0.5, 1.5), _rec(1.0, 1.25), _rec(1.2, 1.3), _rec(0.0, 0.5)],
           "opened": 1.0, "closed": 2.0}
# the engine before the counters and the admission mark
PARENT = {"stats": {"decode_steps": 4, "tokens_out": 40, "prefills": 2},
          "recs": [_rec(0.5), _rec(1.0)], "opened": 1.0, "closed": 2.0}


def test_step_host_ms_reads_the_counters():
    assert reader("step_host_ms")(PROGRAM) == pytest.approx(1.0)


def test_queue_wait_reads_the_window_admissions():
    # admitted in (1, 2]: waits 1.0, 0.25, 0.1 s; the fourth before the window
    assert reader("queue_wait_p90_ms")(PROGRAM) == pytest.approx(
        (0.25 + (1.0 - 0.25) * 0.8) * 1e3)


@pytest.mark.parametrize("metric", ["step_host_ms", "queue_wait_p90_ms"])
def test_readers_give_none_without_the_program_instruments(metric):
    assert reader(metric)(PARENT) is None
    assert reader(metric)(dict(PARENT, stats={}, recs=[])) is None


def test_readers_read_a_run_of_the_program():
    """A tiny cell on the CPU (a clock that moves 1 ms a read): the host's
    own share of a step lies inside the window's step, and each request
    admitted in the window waited a positive time."""
    out = tiny.run(tiny.cell("t", "h2o-danube-1.8b"), 5, 0.3)
    ctx = out["ctx"]
    host = reader("step_host_ms")(ctx)
    step = reader("engine_step_ms")(ctx)
    assert 0 < host < step
    assert ctx["stats"]["steps"] == ctx["steps"]
    assert reader("queue_wait_p90_ms")(ctx) > 0


SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
COPIES = ("cudaMemcpyAsync", "cudaMemcpy")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: host waits exist only on the card")
    return torch


@pytest.mark.card
def test_step_host_ms_leaves_no_wait_on_the_device_in_host_time(card):
    """`step_host_ms` takes the engine's declared waits (`mz.sync`) out of
    a step.  On the card, at rag's size (prefills of 1500 tokens, whose
    forward a blocking copy after its launch would wait out), the runtime
    calls that can block the host (a synchronize, a copy to or from host
    memory; a copy between two device buffers does not block) add up
    outside `mz.sync` to under 2 % of their time."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from harness import runner
    from harness.bench import load_cell
    from repro_torch.serving.engine import Request

    eng, _ = runner.build(load_cell("danube.rag"), 7, "cuda", log=lambda m: None)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, 32000, 1500).astype(np.int32),
                    max_new_tokens=6) for i in range(8)]
    for r in reqs[:4]:
        eng.submit(r)
    eng.step()                          # kernels and allocator warm
    for r in reqs[4:]:
        eng.submit(r)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
    events = prof.profiler.kineto_results.events()
    on_device = {e.correlation_id(): e.name() for e in events
                 if e.device_type() == DeviceType.CUDA and e.name().startswith("Memcpy")}
    syncs, waits = [], []
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        if e.is_user_annotation() and e.name() == "mz.sync":
            syncs.append((e.start_ns(), e.end_ns()))
        elif e.name() in SYNCS or (e.name() in COPIES and
                                   "DtoD" not in on_device.get(e.correlation_id(), "")):
            waits.append((e.start_ns(), e.end_ns() - e.start_ns()))
    inside = sum(d for t, d in waits if any(s <= t <= e for s, e in syncs))
    outside = sum(d for _, d in waits) - inside
    assert all(r.done for r in reqs) and inside > 0
    assert outside < 0.02 * (inside + outside), (outside / 1e6, inside / 1e6)
