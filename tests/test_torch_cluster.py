"""The serving cluster of the PyTorch/CUDA port (`serving/cluster.py`) on
the CPU against the JAX package's, float32, on the same transferred
weights:

* `LoadGenerator.schedule` gives the JAX trace (arrival times, prompts,
  deadlines) for a seed;
* the router picks the JAX router's replicas over a scripted sequence
  of submissions and steps, under each policy;
* per-request tokens and finish reasons, the summary's counters, the
  per-replica rows and the watchdog's log equal the JAX cluster's in a
  clean run, a kill and restart, a total outage then a restart, retry
  budget poison, backpressure shedding, a stall quarantine, a nan
  quarantine (gather route and pool route) and a generated chaos script;
* a mixed fleet (a transformer and an rwkv6 replica, tagged requests) is
  token-equal to the JAX fleet;
* the replicas share one set of weight tensors, and a restart rebuilds
  the engine from the stored arguments.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import api as jax_api
from repro.models.config import ModelConfig as JaxConfig
from repro.serving import cluster as jax_cluster
from repro.serving import resilience as jax_res
from repro.serving import workload as jax_workload
from repro.serving.engine import Request as JaxRequest
from repro_torch import bridge, configs
from repro_torch.models.config import ModelConfig
from repro_torch.serving import cluster, resilience, workload
from repro_torch.serving.engine import Request

TINY_KW = dict(name="tiny-cluster", n_layers=2, d_model=32, n_heads=4, kv_heads=2,
               head_dim=8, d_ff=64, vocab=61, dtype="float32", param_dtype="float32",
               scan_layers=False)
KERNEL_IMPLS = dict(attn_impl="flash", mlp_impl="fused", norm_impl="fused")
ENGINE_KW = dict(max_batch=2, max_len=64, page_size=8, num_pages=33)
# the summary's keys that do not depend on the host's clock
COUNTERS = ("n_replicas", "router", "tokens_out", "preemptions", "rejected", "requeued",
            "replica_failures", "n_unrouted", "shed", "poisoned", "quarantined",
            "restarts", "goodput_tokens", "peak_queue_depth", "min_free_pages",
            "n_finished")
ROW_KEYS = ("replica", "healthy", "tokens_out", "decode_steps", "prefills",
            "preemptions", "rejected", "n_finished")


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray,
                        jax_api.init_params(JaxConfig(**TINY_KW), jax.random.PRNGKey(0)))


class Side:
    """One package's cluster API, so a scenario runs on both."""

    def __init__(self, port: bool, weights, impls):
        self.port = port
        self.Request = Request if port else JaxRequest
        self.res = resilience if port else jax_res
        self.mod = cluster if port else jax_cluster
        self.cfg = (ModelConfig if port else JaxConfig)(**TINY_KW).replace(**impls)
        self.params = bridge.tree_to_torch(weights) if port else weights

    def cluster(self, **kw):
        kw = {**ENGINE_KW, "n_replicas": 2, "router": "round_robin", **kw}
        if self.port:
            kw["device"] = "cpu"
        return self.mod.ServingCluster(self.cfg, self.params, **kw)

    def requests(self, n, seed, max_new=6, bands=((4, 9), (10, 14))):
        w = workload if self.port else jax_workload
        return w.zipf_mix_requests(np.random.default_rng(seed), n, 61, bands=bands,
                                   max_new_tokens=max_new)

    def one(self, rid, max_new, plen):
        return self.Request(rid=rid, prompt=np.arange(plen, dtype=np.int32) + 1,
                            max_new_tokens=max_new)


def _clean(s):
    cl = s.cluster()
    reqs = s.requests(6, 3)
    for r in reqs:
        cl.submit(r)
    cl.run()
    return cl, reqs


def _kill_restart(s):
    cl = s.cluster()
    reqs = s.requests(6, 2)
    for r in reqs:
        cl.submit(r)
    for _ in range(2):
        cl.step()
    cl.kill_replica(0)
    for _ in range(3):
        cl.step()
    cl.restart_replica(0)
    reqs += s.requests(4, 4)
    for r in reqs[6:]:
        r.rid += 100
        cl.submit(r)
    cl.run()
    return cl, reqs


def _outage(s):
    cl = s.cluster()
    reqs = s.requests(4, 9)
    for r in reqs:
        cl.submit(r)
    for _ in range(2):
        cl.step()
    cl.kill_replica(0)
    cl.kill_replica(1)
    cl.run()                       # nothing healthy: returns at once
    assert not cl.healthy and cl.metrics.summary(cl)["aggregate"]["n_unrouted"] > 0
    late = s.one(99, 3, 5)
    assert cl.submit(late) == -1
    cl.restart_replica(0)
    cl.run()
    return cl, reqs + [late]


def _poison(s):
    cl = s.cluster(n_replicas=3, retry_budget=1)
    req = s.one(0, 8, 6)
    cl.submit(req)
    cl.step()
    cl.kill_replica(cl.assignment[req.rid])
    cl.kill_replica(cl.assignment[req.rid])
    assert req.finish_reason == "poison"
    rest = s.requests(3, 6)
    for r in rest:
        r.rid += 1
        cl.submit(r)
    cl.run()
    return cl, [req] + rest


def _backpressure(s):
    cl = s.cluster(queue_bound=1)
    reqs = s.requests(4, 5)
    assert [cl.submit(r) for r in reqs] == [0, 1, -1, -1]
    cl.run()
    return cl, reqs


def _stall(s):
    cl = s.cluster(watchdog=s.res.Watchdog(2, stall_steps=3))
    reqs = s.requests(6, 5)
    for r in reqs:
        cl.submit(r)
    for _ in range(2):
        cl.step()
    cl.stall_replica(0)
    cl.run()
    return cl, reqs


def _nan(s):
    cl = s.cluster()
    reqs = s.requests(6, 8)
    for r in reqs:
        cl.submit(r)
    for _ in range(2):
        cl.step()
    assert s.res.inject_nan(cl.replicas[0])
    cl.run()
    assert cl.replicas[0].health["nan_detected"]
    return cl, reqs


def _chaos(s):
    cl = s.cluster(watchdog=s.res.Watchdog(2, stall_steps=4))
    reqs = s.requests(8, 7, max_new=8)
    for r in reqs:
        cl.submit(r)
    chaos = s.res.ChaosSchedule.generate(3, n_replicas=2, horizon=40, restart_after=6)
    cl.run(chaos=chaos)
    return cl, reqs


SCENARIOS = {"clean": _clean, "kill_restart": _kill_restart, "outage": _outage,
             "poison": _poison, "backpressure": _backpressure, "stall": _stall,
             "nan": _nan, "chaos": _chaos}


def _digest(cl, reqs):
    summ = cl.metrics.summary(cl)
    return {"tokens": {r.rid: list(r.out_tokens) for r in reqs},
            "finish": {r.rid: r.finish_reason for r in reqs},
            "counters": {k: summ["aggregate"][k] for k in COUNTERS},
            "rows": [{k: row[k] for k in ROW_KEYS} for row in summ["per_replica"]],
            "stats": dict(cl.stats), "events": list(cl.watchdog.events),
            "healthy": list(cl.healthy), "assignment": dict(cl.assignment)}


@pytest.mark.parametrize("name,impls", [(n, {}) for n in SCENARIOS] + [
    ("nan", KERNEL_IMPLS), ("kill_restart", KERNEL_IMPLS)],
    ids=[f"{n}-gather" for n in SCENARIOS] + ["nan-pool", "kill_restart-pool"])
def test_cluster_scenario_matches_jax(weights, name, impls):
    got = _digest(*SCENARIOS[name](Side(True, weights, impls)))
    want = _digest(*SCENARIOS[name](Side(False, weights, impls)))
    assert got == want
    assert all(f is not None for f in got["finish"].values())


def test_load_generator_schedule_matches_jax():
    for rate, bands in ((0.0, None), (4.0, None), (2.5, workload.DEFAULT_DEADLINE_BANDS)):
        kw = dict(n_requests=12, rate=rate, vocab=97, seed=5, max_new_tokens=7,
                  deadline_bands=bands)
        got = cluster.LoadGenerator(**kw).schedule()
        want = jax_cluster.LoadGenerator(**kw).schedule()
        assert [t for t, _ in got] == [t for t, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert (a.rid, a.prompt.tolist(), a.max_new_tokens, a.deadline_s) == \
                (b.rid, b.prompt.tolist(), b.max_new_tokens, b.deadline_s)


@pytest.mark.parametrize("policy", cluster.ROUTER_POLICIES)
def test_router_picks_match_jax(weights, policy):
    picks = []
    for port in (True, False):
        s = Side(port, weights, {})
        cl = s.cluster(n_replicas=3, router=policy)
        seq = []
        for i, r in enumerate(s.requests(9, 11)):
            seq.append(cl.submit(r))
            if i % 3 == 2:
                cl.step()
            if i == 4:
                cl.kill_replica(1)
        picks.append(seq)
    assert picks[0] == picks[1]
    with pytest.raises(ValueError, match="unknown router"):
        cluster.Router("random")


def test_mixed_fleet_matches_jax():
    names = ("smollm-135m", "rwkv6-3b")
    jcfgs = [jax_configs.get_smoke_config(n) for n in names]
    tcfgs = [configs.get_smoke_config(n) for n in names]
    wts = [jax.tree.map(np.asarray, jax_api.init_params(c, jax.random.PRNGKey(i)))
           for i, c in enumerate(jcfgs)]
    out = []
    for port, cfgs, w_mod in ((True, tcfgs, workload), (False, jcfgs, jax_workload)):
        params = [bridge.tree_to_torch(w) for w in wts] if port else wts
        traces = [w_mod.zipf_mix_requests(np.random.default_rng(seed), 4, c.vocab,
                                          bands=((3, 8),), max_new_tokens=5, model=c.name)
                  for seed, c in zip((2, 9), cfgs)]
        merged = w_mod.interleave_tagged(traces)
        kw = dict(max_batch=2, max_len=32, paged=False)
        if port:
            kw["device"] = "cpu"
        mod = cluster if port else jax_cluster
        cl = mod.ServingCluster(cfgs[0], params[0],
                                replica_models=list(zip(cfgs, params)), **kw)
        for r in merged:
            cl.submit(r)
        cl.run()
        for r in merged:
            assert cl.replicas[cl.assignment[r.rid]].mcfg.name == r.model
        out.append([(r.rid, r.model, r.out_tokens, r.finish_reason) for r in merged])
    assert out[0] == out[1]


def test_replicas_share_weights_and_restart_rebuilds(weights):
    s = Side(True, weights, {})
    cl = s.cluster()
    a, b = (e.params["segments"][0]["kind_dense"]["attn"]["wq"] for e in cl.replicas)
    assert a.data_ptr() == b.data_ptr() == s.params["segments"][0]["kind_dense"][
        "attn"]["wq"].data_ptr()
    old = cl.replicas[0]
    old.stats.update(decode_steps=3, nan_steps=1, tokens_out=5)
    cl.kill_replica(0)
    assert cl.restart_replica(0) == 0 and cl.restart_replica(0) == 0
    assert cl.replicas[0] is not old and cl.healthy == [0, 1]
    assert cl.replicas[0].pool.free_pages == old.pool.free_pages
    assert cl.stats["restarts"] == 1
    # the retired engine's counters fold into the cluster's
    assert (cl._retired["decode_steps"], cl._retired["nan_steps"],
            cl._retired["tokens_out"]) == (3, 1, 5)
    assert cl.replicas[0].stats["decode_steps"] == 0


def test_empty_cluster_summary(weights):
    s = Side(True, weights, {})
    cl = s.cluster()
    agg = cl.metrics.summary(cl)["aggregate"]
    assert agg["tokens_out"] == 0 and agg["ttft_p50_ms"] == 0.0
    assert agg["peak_queue_depth"] == 0 and agg["n_unrouted"] == 0
    with pytest.raises(ValueError, match="at least one replica"):
        cluster.ServingCluster(s.cfg, s.params, n_replicas=-1, device="cpu")
    with pytest.raises(ValueError, match="replica_models"):
        cluster.ServingCluster(s.cfg, s.params, n_replicas=3, device="cpu",
                               replica_models=[(s.cfg, s.params)] * 2)
    assert torch.equal(cl.replicas[0].params["embed"], s.params["embed"])


def test_serve_cluster_cli_on_cpu(capsys):
    from repro_torch.launch import serve as serve_mod

    serve_mod.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--replicas", "2",
                    "--router", "least_loaded", "--rate", "50", "--deadline-ms", "60000",
                    "--chaos", "--chaos-seed", "1", "--requests", "4", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "chaos script" in out and "cluster x2 router=least_loaded" in out
    assert "unrouted=0" in out and out.count("replica ") >= 2
    cfg = configs.get_smoke_config("smollm-135m")
    _, params, kw = serve_mod.prepare(cfg, device="cpu")
    s = serve_mod.serve_cluster(cfg, params, n_replicas=2, n_requests=6, max_new=3,
                                chaos_horizon=64, log=lambda x: None, max_len=64, **kw)
    agg = s["aggregate"]
    assert agg["tokens_out"] == 18 and agg["n_unrouted"] == 0 and agg["n_finished"] == 6
    assert len(s["per_replica"]) == 2 and s["tokens_per_s"] > 0
    assert s["chaos"].events and all(r.done for r in s["requests"])
