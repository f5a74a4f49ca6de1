"""The serving cluster and spec-decode on a mesh: the port's
`ServingCluster(mesh=...)` on per-replica meshes and
`SpecDecodeEngine(mesh=...)` against the JAX package's unsharded ones,
on the CPU.

Gloo ranks spawned on the CPU (`_torch_mesh.run`, one spawn a mesh):

* the cluster on meshes (2, 1) (two replicas of one rank) and (2, 2)
  (two replicas, tensor-parallel over 2 ranks each), float32, against
  the JAX `ServingCluster` with 2 unsharded replicas on the same
  weights: per-request tokens, finish reasons, the summary's counters,
  the per-replica rows, the cluster's stats, the watchdog's log and the
  routing equal under `round_robin` and `least_loaded`, and through the
  seed-0 chaos drill (a nan quarantine, a kill, restarts, requeues);
  every rank ends with the same request records (tokens, finish,
  admission order, marks);
* an open-loop run with deadlines tight enough to shed: every rank's
  records (shed and finish decisions, TTFT / finish marks from the
  agreed clock) identical, every request done;
* `SpecDecodeEngine(mesh=...)` on (1, 2) (the target's 4 / 2 heads
  split, the draft whole on each rank): tokens, finish reasons and
  `spec_stats` equal to the JAX `SpecDecodeEngine`'s.

And the launcher: under a tp policy it starts one rank a card (JAX's
(cards / tp, tp) mesh, whose data axis `--replicas N` splits).
"""
import json

import jax
import numpy as np
import pytest
import torch

import _torch_mesh
from repro.models import api as jax_api
from repro.models.config import ModelConfig as JaxConfig
from repro.serving import cluster as jax_cluster
from repro.serving import resilience as jax_res
from repro.serving import workload as jax_workload
from repro.serving.engine import Request as JaxRequest
from repro.serving.specdec import SpecDecodeEngine as JaxSpecEngine
from repro.serving.specdec import shared_trunk_draft as jax_shared_trunk_draft
from repro_torch import bridge
from repro_torch.models.config import ModelConfig

TINY_KW = dict(name="tiny-cluster", n_layers=2, d_model=32, n_heads=4, kv_heads=2,
               head_dim=8, d_ff=64, vocab=61, dtype="float32", param_dtype="float32",
               scan_layers=False)
ENGINE_KW = dict(max_batch=2, max_len=64, page_size=8, num_pages=33)
BANDS = ((4, 9), (10, 14))
# (name, job kwargs): closed loop under two routers, the seed-0 chaos drill
RUNS = {"round_robin": dict(mode="closed", router="round_robin", n_requests=8, seed=7),
        "least_loaded": dict(mode="closed", router="least_loaded", n_requests=8, seed=7),
        "chaos": dict(mode="chaos", router="round_robin", n_requests=10, seed=7,
                      chaos=(0, 20, 4), stall_steps=4)}
OPEN = dict(mode="open", n_requests=10, seed=3, rate=400.0, deadline_s=0.03)
COUNTERS = ("n_replicas", "router", "tokens_out", "preemptions", "rejected", "requeued",
            "replica_failures", "n_unrouted", "shed", "poisoned", "quarantined",
            "restarts", "goodput_tokens", "peak_queue_depth", "min_free_pages",
            "n_finished")
ROW_KEYS = ("replica", "healthy", "tokens_out", "decode_steps", "prefills",
            "preemptions", "rejected", "n_finished")
CLUSTER_MESHES = [(2, 1), (4, 2)]    # (world, model axis): (2, 1) and (2, 2)
SPEC_MESH = (2, 2)                   # (1, 2)
SPEC_KW = dict(TINY_KW, name="spec", n_layers=4)
SPEC = dict(n_draft=1, k=3, max_new=8)
MAX_NEW = 8


def _jax_cluster(w, mode, router, n_requests, seed, chaos=None, stall_steps=50):
    cl = jax_cluster.ServingCluster(JaxConfig(**TINY_KW), w, n_replicas=2, router=router,
                                    watchdog=jax_res.Watchdog(2, stall_steps=stall_steps),
                                    **ENGINE_KW)
    reqs = jax_workload.zipf_mix_requests(np.random.default_rng(seed), n_requests, 61,
                                          bands=BANDS, max_new_tokens=MAX_NEW)
    for r in reqs:
        cl.submit(r)
    script = None if mode != "chaos" else jax_res.ChaosSchedule.generate(
        chaos[0], n_replicas=2, horizon=chaos[1], restart_after=chaos[2])
    cl.run(chaos=script)
    summ = cl.metrics.summary(cl)
    return {"tokens": {r.rid: list(r.out_tokens) for r in reqs},
            "finish": {r.rid: r.finish_reason for r in reqs},
            "aggregate": summ["aggregate"], "rows": summ["per_replica"],
            "stats": dict(cl.stats), "events": list(cl.watchdog.events),
            "healthy": list(cl.healthy), "assignment": dict(cl.assignment)}


def _spec_prompts():
    rng = np.random.default_rng(13)
    return [rng.integers(0, 61, size=int(rng.integers(3, 8))).astype(np.int32)
            for _ in range(4)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    w = jax.tree.map(np.asarray, jax_api.init_params(JaxConfig(**TINY_KW),
                                                     jax.random.PRNGKey(0)))
    tcfg, tw = ModelConfig(**TINY_KW), bridge.tree_to_torch(w)
    jobs = []
    for name, kw in RUNS.items():
        jobs.append((name, "cluster", dict(cfg=tcfg, params=tw, n_replicas=2, max_new=MAX_NEW,
                                           bands=BANDS, **kw, **ENGINE_KW), CLUSTER_MESHES))
    jobs.append(("open", "cluster", dict(cfg=tcfg, params=tw, n_replicas=2, max_new=MAX_NEW,
                                         bands=BANDS, **OPEN, **ENGINE_KW), CLUSTER_MESHES))
    # spec-decode: a 4-layer target (4 / 2 heads split over 2), 1-layer draft
    jcfg = JaxConfig(**SPEC_KW)
    sw = jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))
    jobs.append(("spec", "spec", dict(cfg=ModelConfig(**SPEC_KW), params=bridge.tree_to_torch(sw),
                                      n_draft=SPEC["n_draft"], k=SPEC["k"],
                                      prompts=_spec_prompts(), max_new=SPEC["max_new"],
                                      max_batch=2, max_len=32, decode_batch=1), [SPEC_MESH]))

    def jax_side():
        want = {name: _jax_cluster(w, **kw) for name, kw in RUNS.items()}
        jdcfg, jdw = jax_shared_trunk_draft(jcfg, sw, SPEC["n_draft"])
        jeng = JaxSpecEngine(jcfg, sw, jdcfg, jdw, k=SPEC["k"], max_batch=2, max_len=32,
                             decode_batch=1)
        reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=SPEC["max_new"])
                for i, p in enumerate(_spec_prompts())]
        for r in reqs:
            jeng.submit(r)
        jeng.run()
        st = jeng.spec_stats
        want["spec"] = ([r.out_tokens for r in reqs], [r.finish_reason for r in reqs],
                        (st.iterations, st.proposed, st.accepted, st.bonus))
        return want

    return _torch_mesh.run(tmp_path_factory.mktemp("cl"), CLUSTER_MESHES + [SPEC_MESH], jobs,
                           meanwhile=jax_side)


@pytest.mark.parametrize("mesh", CLUSTER_MESHES, ids=lambda m: f"world{m[0]}-model{m[1]}")
@pytest.mark.parametrize("name", list(RUNS))
def test_cluster_matches_jax_unsharded_replicas(runs, name, mesh):
    want, got = runs
    out, ref = got[mesh][name], want[name]
    for key in ("tokens", "finish", "stats", "events", "healthy", "assignment"):
        assert out[key] == ref[key], key
    assert {k: out["aggregate"][k] for k in COUNTERS} == \
        {k: ref["aggregate"][k] for k in COUNTERS}
    assert [{k: r[k] for k in ROW_KEYS} for r in out["rows"]] == \
        [{k: r[k] for k in ROW_KEYS} for r in ref["rows"]]
    assert all(f is not None for f in out["finish"].values())
    if name == "chaos":      # the drill bites: a nan quarantine, a kill, requeues
        assert out["stats"]["quarantined"] >= 1 and out["stats"]["replica_failures"] >= 2
        assert out["stats"]["requeued"] > 0 and out["poisoned"]


@pytest.mark.parametrize("mesh", CLUSTER_MESHES, ids=lambda m: f"world{m[0]}-model{m[1]}")
@pytest.mark.parametrize("name", list(RUNS) + ["open"])
def test_every_rank_holds_the_same_records(runs, name, mesh):
    _, got = runs
    ranks = got[mesh][name]["ranks"]
    assert len(ranks) == mesh[0]
    assert all(r == ranks[0] for r in ranks[1:])
    # each step: one all_gather over "data", one broadcast of the clock
    out = got[mesh][name]
    assert out["counts"]["all_gather"] >= out["stats"]["steps"]


@pytest.mark.parametrize("mesh", CLUSTER_MESHES, ids=lambda m: f"world{m[0]}-model{m[1]}")
def test_open_loop_deadlines_agree_on_every_rank(runs, mesh):
    _, got = runs
    out = got[mesh]["open"]
    records = out["ranks"][0]
    assert len(records) == OPEN["n_requests"]
    assert all(done and reason is not None for _, _, reason, done, *_ in records)
    # every mark comes from the agreed clock: submit <= first <= done
    for _, toks, reason, _, _, _, t_sub, t_first, t_done in records:
        assert t_sub is not None and t_done is not None and t_sub <= t_done
        if toks:
            assert t_sub <= t_first <= t_done
    assert out["aggregate"]["n_finished"] == OPEN["n_requests"]


def test_spec_decode_on_a_mesh_matches_jax(runs):
    want, got = runs
    out = got[SPEC_MESH]["spec"]
    tokens, reasons, stats = want["spec"]
    assert out["tokens"] == tokens and out["reasons"] == reasons
    assert out["spec_stats"] == stats
    # the target's verify ran sharded: its attention and MLP reduce
    assert out["counts"]["all_reduce"] > 0 and out["counts"]["broadcast"] > 0


def _tp_policy(tmp_path, tp):
    from repro.core.policy import ExecutionPolicy as JaxPolicy
    from repro.core.policy import OperatorPolicy as JaxOperatorPolicy
    ops = [JaxOperatorPolicy(group=g, batch=4, tp=tp, memory="HBM3",
                             chiplet="WS-pe64-glb512K-2D", fused=True)
           for g in ("norm1+qkv_proj+attention", "norm2+mlp")]
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(JaxPolicy(network="n", interval_s=1e-3,
                                         operators=ops).to_dict()))
    return path


@pytest.mark.parametrize("argv,cards,world", [
    (["--replicas", "2"], 4, 4), (["--scenario", "specdec"], 2, 2), ([], 2, 2),
    (["--arch", "rwkv6-3b"], 2, 2)])
def test_serve_main_starts_replicas_times_tp_ranks(tmp_path, monkeypatch, argv, cards, world):
    import torch.multiprocessing as mp

    from repro_torch.launch import serve as tserve

    path = _tp_policy(tmp_path, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    seen = {}
    monkeypatch.setattr(mp, "spawn", lambda fn, args, nprocs, join: seen.update(
        fn=fn, args=args, nprocs=nprocs))
    arch = [] if "--arch" in argv else ["--arch", "smollm-135m"]
    tserve.main(arch + ["--smoke", "--policy", str(path)] + argv)
    assert seen["nprocs"] == world and seen["args"][:2] == (world, 2)
