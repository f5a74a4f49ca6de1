"""The port's profiler spans and engine counters on the CPU.

Under `torch.profiler` a small engine's run shows the span tree
`mz.step` > `mz.admit` > `mz.prefill` > `mz.attn` / `mz.mlp` (`mz.moe`)
and `mz.step` > `mz.decode` > the same layer spans, each prefill named
with its request's id; with no profiler no `record_function` is made.
The counters (`steps`, `step_us`, `sync_wait_us`, `occupied_slot_steps`)
and the `t_admit` mark hold their definitions, and the engine's tokens
and occupancy match the JAX engine's.
"""
import re

import jax
import numpy as np
import pytest
import torch.autograd.profiler as tprof
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro.models import api as jax_api
from repro.models.config import ModelConfig as JaxConfig
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import bridge, spans
from repro_torch.kernels import _build
from repro_torch.launch.serve import serve
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.specdec import SpecDecodeEngine, shared_trunk_draft

TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, kv_heads=2, head_dim=16,
            d_ff=128, vocab=97, dtype="float32", param_dtype="float32", scan_layers=False)
MOE = dict(TINY, n_experts=4, top_k=2)
# (model, paged): the dense KV state, the page pool, a routed MoE, and
# speculative decoding (a one-layer shared-trunk draft, paged None)
ENGINES = {"dense": (TINY, False), "paged": (TINY, True), "moe": (MOE, False),
           "spec": (TINY, None)}


class StepClock:
    """A clock that moves 1 ms at each read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


def _prompts(n=5, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, size=int(rng.integers(3, 10))).astype(np.int32)
            for _ in range(n)]


def _engine(name, clock=None):
    kw, paged = ENGINES[name]
    cfg = ModelConfig(**kw)
    params = api.init_params(cfg, 0, device="cpu")
    if paged is None:
        dcfg, dparams = shared_trunk_draft(cfg, params, 1)
        eng = SpecDecodeEngine(cfg, params, dcfg, dparams, k=2, max_batch=2, max_len=32,
                               device="cpu")
    else:
        eng = ServingEngine(cfg, params, max_batch=2, max_len=32, paged=paged, device="cpu")
    if clock is not None:
        eng.clock = clock
    reqs = [Request(rid=100 + i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(_prompts())]
    return eng, reqs


def _run(eng, reqs) -> int:
    for r in reqs:
        eng.submit(r)
    n = 0
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        n += 1
    return n


def _spans(name):
    """(engine, requests, [(start, end, name)] of the mz.* host spans) of
    one run under the profiler (CPU activity)."""
    eng, reqs = _engine(name)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(eng, reqs)
    out = [(e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU and e.name().startswith("mz.")]
    return eng, reqs, sorted(out)


def _kind(name):
    return name.split(" ", 1)[0]


def _parents(sp, all_spans):
    """The kinds of the spans that enclose `sp`."""
    s, e, _ = sp
    return {_kind(n) for s2, e2, n in all_spans if (s2, e2) != (s, e) and s2 <= s and e <= e2}


@pytest.fixture(scope="module")
def runs():
    return {name: _spans(name) for name in ENGINES}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_span_tree(runs, name):
    _, _, sp = runs[name]
    ffn = "mz.moe" if name == "moe" else "mz.mlp"
    kinds = {_kind(n) for *_, n in sp}
    assert {"mz.step", "mz.admit", "mz.prefill", "mz.decode", "mz.sync", "mz.attn", ffn,
            "mz.unembed"} <= kinds, kinds
    for s in sp:
        k, up = _kind(s[2]), _parents(s, sp)
        if k == "mz.prefill":
            assert {"mz.step", "mz.admit"} <= up, up
        if k == "mz.decode":
            assert "mz.step" in up and "mz.admit" not in up, up
        if k in ("mz.admit", "mz.sync"):
            assert "mz.step" in up, (k, up)
        if k in ("mz.attn", ffn, "mz.unembed"):
            # a layer span sits in exactly one of the phases
            assert len(up & {"mz.prefill", "mz.decode"}) == 1, (k, up)
            assert "mz.admit" in up if "mz.prefill" in up else "mz.admit" not in up
    for phase in ("mz.prefill", "mz.decode"):
        inside = {_kind(x[2]) for x in sp if phase in _parents(x, sp)}
        assert {"mz.attn", ffn, "mz.unembed"} <= inside, (phase, inside)
    other = "mz.mlp" if name == "moe" else "mz.moe"
    assert other not in kinds


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_prefill_spans_carry_their_request(runs, name):
    eng, reqs, sp = runs[name]
    named = [re.fullmatch(r"mz\.prefill rid=(\d+) len=(\d+)", n) for *_, n in sp
             if _kind(n) == "mz.prefill"]
    assert all(named) and len(named) == eng.stats["prefills"]
    got = sorted((int(m[1]), int(m[2])) for m in named)
    assert got == sorted((r.rid, len(r.prompt)) for r in reqs)


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_admission_marks_order(runs, name):
    _, reqs, _ = runs[name]
    for r in reqs:
        assert r.t_submit <= r.t_admit <= r.t_first <= r.t_done


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_no_record_function_without_profiler(monkeypatch, name):
    def refuse(*a, **k):
        raise AssertionError("record_function made with no profiler running")

    monkeypatch.setattr(tprof, "record_function", refuse)
    assert spans.span("mz.step") is spans.span("mz.decode", "x")
    eng, reqs = _engine(name)
    _run(eng, reqs)
    assert all(r.done for r in reqs)
    with pytest.raises(AssertionError, match="no profiler"):
        with profile(activities=[ProfilerActivity.CPU]):
            with spans.span("mz.step"):
                pass


def test_port_launches_run_inside_a_host_op():
    """A launch of a port library runs inside `mz.launch`, a host op (not
    a user range: the profiler links a kernel to an op open at its
    launch); with no profiler, inside no range at all."""
    seen = []
    launcher = _build.Launcher("fused_norm", "fused_rmsnorm", [])
    launcher._fn = lambda *a: seen.append(tprof._is_profiler_enabled) or 0
    launcher(1, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        launcher(1, 2)
    ev = [e for e in prof.profiler.kineto_results.events() if e.name() == "mz.launch"]
    assert len(ev) == 1 and not ev[0].is_user_annotation() and ev[0].correlation_id()
    assert seen == [False, True] and launcher.launches == 2
    assert spans.op("mz.launch") is spans.span("mz.step")


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_counters(name):
    """Under a clock that moves 1 ms a read: each device read is one
    interval of two reads, `steps` counts `step()` calls, and a step's
    host time holds its reads."""
    eng, reqs = _engine(name, StepClock())
    calls = _run(eng, reqs)
    st = eng.stats
    assert st["steps"] == calls
    # two reads a decode step (the guard, the tokens), one a fresh prefill
    assert st["sync_wait_us"] == 1000 * (2 * st["decode_steps"] + st["prefills"])
    assert st["step_us"] > st["sync_wait_us"]
    assert st["decode_steps"] <= st["occupied_slot_steps"] <= 2 * st["decode_steps"]
    assert all(isinstance(v, int) for v in st.values())


def test_counters_count_the_window():
    """`serve()`'s occupancy: the mean live share of the slots over its
    own decode steps, from the `occupied_slot_steps` counter."""
    eng, reqs = _engine("dense")
    first = serve(eng, reqs[:2])
    before = dict(eng.stats)
    second = serve(eng, reqs[2:])
    d = {k: eng.stats[k] - before[k] for k in before}
    assert second["occupancy"] == pytest.approx(
        d["occupied_slot_steps"] / (d["decode_steps"] * eng.max_batch))
    assert 0 < first["occupancy"] <= 1 and 0 < second["occupancy"] <= 1


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "profiled"])
def test_tokens_and_occupancy_match_jax(traced):
    """Spans and counters change no token: the port's engine, with the
    profiler on or off, against the JAX engine on the same weights; the
    occupancy counter gives the JAX engine's mean occupancy."""
    jcfg, tcfg = JaxConfig(**TINY), ModelConfig(**TINY)
    w = jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))
    kw = dict(max_batch=2, max_len=32, paged=False)
    jeng = JaxEngine(jcfg, w, **kw)
    teng = ServingEngine(tcfg, bridge.tree_to_torch(w), device="cpu", **kw)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(_prompts())]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(_prompts())]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            _run(teng, treqs)
    else:
        _run(teng, treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    for key in ("decode_steps", "prefills", "tokens_out", "preemptions", "rejected", "shed",
                "nan_steps"):
        assert teng.stats[key] == jeng.stats[key], key
    occ = teng.stats["occupied_slot_steps"] / (teng.stats["decode_steps"] * teng.max_batch)
    assert occ == pytest.approx(float(np.mean(jeng.stats["slot_occupancy"])))
