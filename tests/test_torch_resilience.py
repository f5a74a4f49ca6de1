"""The resilience layer of the PyTorch/CUDA port (`serving/resilience.py`)
on the CPU, against the JAX package where both have the same function:

* `ChaosSchedule.generate` gives the JAX events for seeds 0-4; events
  sort and fire in step order; unknown kinds are refused;
* the `Watchdog`'s stall / idle / nan rules, the port's and the JAX
  watchdog fed the same scripted replica states;
* `goodput_tokens` / `goodput_violations` on one request list;
* `inject_nan` on the port's paged (gather and pool route), int8 paged,
  dense, int8 dense and recurrent (rwkv6, rglru) engines makes the next
  step flag `nan_detected` and emit nothing, and is a no-op with no live
  slot; `logits_finite`.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import api as jax_api
from repro.models.config import ModelConfig as JaxConfig
from repro.serving import resilience as jax_res
from repro.serving.engine import Request as JaxRequest
from repro_torch import bridge, configs
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.serving import resilience
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.engine import Request, ServingEngine

TINY_KW = dict(name="tiny-resilience", n_layers=2, d_model=32, n_heads=4, kv_heads=2,
               head_dim=8, d_ff=64, vocab=61, dtype="float32", param_dtype="float32",
               scan_layers=False)
KERNEL_IMPLS = dict(attn_impl="flash", mlp_impl="fused", norm_impl="fused")


@pytest.fixture(scope="module")
def tiny_params():
    return bridge.tree_to_torch(jax.tree.map(
        np.asarray, jax_api.init_params(JaxConfig(**TINY_KW), jax.random.PRNGKey(0))))


# -- chaos schedule -----------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("n_replicas,horizon,extra", [
    (2, 64, {}), (3, 60, {}), (4, 200, dict(kills=2, stalls=3, nans=2, restart_after=5)),
    (1, 10, {})])
def test_chaos_generate_matches_jax(seed, n_replicas, horizon, extra):
    got = resilience.ChaosSchedule.generate(seed, n_replicas=n_replicas,
                                            horizon=horizon, **extra)
    want = jax_res.ChaosSchedule.generate(seed, n_replicas=n_replicas,
                                          horizon=horizon, **extra)
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]
    assert got.pending and not got.fired


def test_chaos_default_seed_is_the_knobs():
    a = resilience.ChaosSchedule.generate(n_replicas=2, horizon=64)
    b = jax_res.ChaosSchedule.generate(0, n_replicas=2, horizon=64)
    assert [dataclasses.astuple(e) for e in a.events] == \
        [dataclasses.astuple(e) for e in b.events]


def test_chaos_event_rejects_unknown_kind_and_sorts():
    with pytest.raises(ValueError, match="unknown chaos kind"):
        resilience.ChaosEvent(1, 0, "meteor")
    s = resilience.ChaosSchedule([resilience.ChaosEvent(5, 0, "restart"),
                                  resilience.ChaosEvent(2, 0, "kill")])
    assert [e.step for e in s.events] == [2, 5]


def test_chaos_apply_fires_in_step_order(tiny_params):
    cl = ServingCluster(ModelConfig(**TINY_KW), tiny_params, n_replicas=2, max_batch=2,
                        max_len=64, page_size=8, num_pages=33, device="cpu")
    sched = resilience.ChaosSchedule([
        resilience.ChaosEvent(5, 0, "restart"), resilience.ChaosEvent(2, 0, "kill"),
        resilience.ChaosEvent(3, 1, "stall"), resilience.ChaosEvent(4, 1, "unstall")])
    assert sched.apply(cl, 1) == []
    assert [e.kind for e in sched.apply(cl, 3)] == ["kill", "stall"]
    assert cl.healthy == [1] and cl.stalled == {1}
    sched.apply(cl, 5)
    assert cl.healthy == [0, 1] and not cl.stalled and not sched.pending
    assert [ev.kind for _, ev in sched.fired] == ["kill", "stall", "unstall", "restart"]


# -- watchdog -----------------------------------------------------------------


@dataclasses.dataclass
class FakeReplica:
    tokens: int = 0
    queued: int = 0
    live: int = 0
    nan: bool = False

    @property
    def health(self):
        return {"nan_detected": self.nan}

    @property
    def stats(self):
        return {"tokens_out": self.tokens}

    @property
    def queue(self):
        return [None] * self.queued

    @property
    def slots(self):
        return [object()] * self.live + [None] * (2 - self.live)


@pytest.mark.parametrize("nan_check", [True, False])
def test_watchdog_rules_match_jax(nan_check):
    # (tokens, queued, live, nan) a check: idle, work without progress,
    # progress, a stall, reset, nan
    script = [(0, 0, 0, False)] * 4 + [(0, 1, 0, False)] * 2 + [(3, 0, 2, False)] + \
        [(3, 0, 2, False)] * 3 + ["reset"] + [(3, 1, 1, False), (4, 1, 1, True),
                                             (4, 0, 0, False)]
    out = []
    for mod in (resilience, jax_res):
        wd = mod.Watchdog(2, stall_steps=3, nan_check=nan_check)
        seq = []
        for item in script:
            if item == "reset":
                wd.reset(1)
                continue
            seq.append(wd.check(1, FakeReplica(*item)))
        out.append(seq)
    assert out[0] == out[1]
    assert "stall" in out[0] and ("nan" in out[0]) == nan_check
    assert resilience.Watchdog(1).stall_steps == 50


# -- goodput ------------------------------------------------------------------


def _finished(cls, rid, n_tok, dl, late=False, reason="max_new_tokens"):
    r = cls(rid=rid, prompt=np.arange(3, dtype=np.int32), max_new_tokens=n_tok,
            deadline_s=dl)
    r.out_tokens = list(range(n_tok))
    r.t_submit = 100.0
    r.t_done = 100.0 + (dl * 2 if late and dl else 0.5)
    r.done = True
    r.finish_reason = reason
    return r


def test_goodput_matches_jax():
    got = []
    for cls, mod in ((Request, resilience), (JaxRequest, jax_res)):
        reqs = [_finished(cls, 0, 4, None), _finished(cls, 1, 3, 10.0),
                _finished(cls, 2, 5, 1.0, late=True),
                _finished(cls, 3, 2, None, reason="shed"),
                _finished(cls, 4, 2, None, reason="poison"),
                _finished(cls, 5, 2, None, reason="rejected"),
                cls(rid=6, prompt=np.arange(3, dtype=np.int32))]
        got.append((mod.goodput_tokens(reqs), mod.goodput_violations(reqs)))
    assert got[0] == got[1] == (7, 0)
    assert resilience.goodput_tokens([]) == 0


# -- inject_nan ---------------------------------------------------------------


def _engine(kind, tiny_params):
    if kind in ("rwkv6", "rglru"):
        cfg = configs.get_smoke_config("rwkv6-3b" if kind == "rwkv6"
                                       else "recurrentgemma-2b")
        return ServingEngine(cfg, api.init_params(cfg, 0, device="cpu"), max_batch=2,
                             max_len=32, device="cpu")
    cfg = ModelConfig(**TINY_KW).replace(**(KERNEL_IMPLS if kind == "paged_pool" else {}))
    kw = {"paged": {"paged_gather": True, "paged_pool": True, "paged_int8": True,
                    "dense": False, "dense_int8": False}[kind],
          "kv_quant": {"paged_int8": True, "dense_int8": "dense"}.get(kind, False)}
    return ServingEngine(cfg, tiny_params, max_batch=2, max_len=64, page_size=8,
                         num_pages=33, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["paged_gather", "paged_pool", "paged_int8", "dense",
                                  "dense_int8", "rwkv6", "rglru"])
def test_inject_nan_trips_the_guard(tiny_params, kind):
    eng = _engine(kind, tiny_params)
    assert not resilience.inject_nan(eng)              # no live slot: a no-op
    for i in range(2):
        eng.submit(Request(rid=i, prompt=np.arange(6, dtype=np.int32) + i,
                           max_new_tokens=8))
    eng.step()
    assert eng.stats["nan_steps"] == 0
    tokens = eng.stats["tokens_out"]
    assert resilience.inject_nan(eng)
    eng.step()
    assert eng.health["nan_detected"] and eng.stats["nan_steps"] == 1
    assert eng.stats["tokens_out"] == tokens           # nothing emitted
    assert eng.step() == 0                             # a sick engine does nothing


def test_logits_finite():
    ok = torch.zeros((2, 61))
    assert resilience.logits_finite(ok)
    bad = ok.clone()
    bad[1, 3] = float("nan")
    assert not resilience.logits_finite(bad)
    bad = ok.clone()
    bad[0, 0] = float("inf")
    assert not resilience.logits_finite(bad)
