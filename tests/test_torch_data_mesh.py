"""Serving with the batch over "data": the port's dense KV state split over
the mesh's data axis against the JAX package's unsharded engine, on the
CPU.

Gloo ranks spawned on the CPU (`_torch_mesh.run`, one spawn a mesh) build
meshes (2, 1) and (2, 2) ("data", "model") and serve, on float32
weights the JAX `init_params` drew (smoke configs cut to 2 layers), each
case below through `ServingEngine(mesh=...)`; greedy tokens and finish
reasons must equal the JAX engine's, unsharded, on the same weights
(where the port's engine has one slot, the JAX engine's with two:
`_jax_switches` says why):

* smollm-135m with `paged=False` at full width (4 slots, 2 a data row)
  and compacted to decode_batch 2 (a row may hold no active lane);
* h2o-danube-1.8b with one slot and prompts past its 64-position
  window: the ring's length over "data" (SP), the owner of a position
  changing as the ring wraps;
* deepseek-v3's MLA latents with one slot (SP) and with 4 slots split
  over "data" (its capacity MoE routed over the gathered batch);
* mixtral-8x7b compacted to 12 of 16 slots with a capacity factor of 0.5,
  so decode drops tokens (checked here on the unsharded port): the
  route must see JAX's lane order;
* the spec-decode target on (2, 1) with 4 slots (each row verifies its
  own) and with one slot (SP in the verify), the draft whole;
* a 2-replica cluster on (4, 1) (each replica's dense slots over its
  own two data rows) against the JAX cluster's unsharded replicas, every
  rank ending with the same request records.

Each rank's dense leaves must have the `local_shape` of `cache_specs`
(the slots, or one slot's length, halved on data 2).  In one process,
with stand-in meshes, the paged pools, int8 dense rectangles, recurrent
and cross-attention states keep every slot on every data rank.
"""
import jax
import numpy as np
import pytest
import torch

import _torch_mesh
from repro import configs as jax_configs
from repro.models import api as jax_api
from repro.serving import cluster as jax_cluster
from repro.serving import workload as jax_workload
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.specdec import SpecDecodeEngine as JaxSpecEngine
from repro.serving.specdec import shared_trunk_draft as jax_shared_trunk_draft
from repro_torch import bridge, configs
from repro_torch.models import api, transformer
from repro_torch.parallel import mesh as pmesh
from repro_torch.parallel import sharding
from repro_torch.serving.engine import Request, ServingEngine

MESHES = [(2, 1), (4, 2)]           # (world, model axis): (2, 1) and (2, 2)
SPEC_MESH = (2, 1)
CLUSTER_MESH = (4, 1)               # 2 replicas of (2, 1)
CLUSTER = dict(n_replicas=2, n_requests=8, seed=7, bands=((4, 9), (10, 14)))
CLUSTER_KW = dict(paged=False, max_batch=4, decode_batch=2, max_len=48)
_INIT = jax.jit(jax_api.init_params, static_argnums=0)
MAX_NEW = 8
# name: (arch, config changes, engine switches, (prompts, their lengths in turn), split);
# few distinct lengths: the JAX engine compiles its prefill once a length
SHORT = (5, 12, 19)
CASES = {
    "smollm_full": ("smollm-135m", {}, dict(paged=False, max_batch=4, max_len=48),
                    (6, SHORT), "rows"),
    "smollm_compact": ("smollm-135m", {}, dict(paged=False, max_batch=4, decode_batch=2,
                                               max_len=48), (6, SHORT), "rows"),
    "danube_sp": ("h2o-danube-1.8b", {}, dict(max_batch=1, max_len=160), (2, (95, 78)),
                  "seq"),
    "deepseek_sp": ("deepseek-v3-671b", {}, dict(max_batch=1, max_len=64), (2, (27, 38)),
                    "seq"),
    "deepseek_rows": ("deepseek-v3-671b", {}, dict(max_batch=4, decode_batch=2, max_len=48),
                      (6, SHORT), "rows"),
    "mixtral_compact": ("mixtral-8x7b", dict(capacity_factor=0.5),
                        dict(max_batch=16, decode_batch=12, max_len=48), (20, SHORT), "rows"),
}
SPEC = dict(n_draft=1, k=3)
SPECS = {"spec_rows": (dict(max_batch=4, decode_batch=2, max_len=48), (6, SHORT), "rows"),
         "spec_sp": (dict(max_batch=1, max_len=48), (2, (12, 23)), "seq")}


def _configs(arch, **kw):
    kw = dict(kw, n_layers=2, scan_layers=False)
    return jax_configs.get_smoke_config(arch).replace(**kw), \
        configs.get_smoke_config(arch).replace(**kw)


def _prompts(n, lens, vocab):
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, size=lens[i % len(lens)]).astype(np.int32)
            for i in range(n)]


def _jax_switches(ekw: dict) -> dict:
    """The JAX engine's switches for a case: two slots where the port's
    has one.  JAX's dense state splices nothing into a lone slot
    (`_tree_set_slot` finds no batch axis when max_batch is 1), so its
    one-slot engine decodes against an empty cache; each request's
    greedy tokens of a two-slot engine are those a one-slot engine
    gives (rows are independent, and no decode of 2 tokens fills a
    capacity of 8)."""
    return dict(ekw, max_batch=2) if ekw["max_batch"] == 1 else ekw


def _run(eng, prompts):
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out_tokens for r in reqs], [r.finish_reason for r in reqs]


def _decode_drops(tcfg, params, prompts, eng_kw) -> int:
    """Choices the port's unsharded engine drops in its decode steps
    (capacity routes over exactly decode_batch tokens)."""
    drops = []
    slots = transformer._slots

    def counted(cfg, flat_idx, cap):
        slot, keep = slots(cfg, flat_idx, cap)
        if flat_idx.numel() == eng_kw["decode_batch"] * cfg.top_k:
            drops.append(int((~keep).sum()))
        return slot, keep

    transformer._slots = counted
    try:
        eng = ServingEngine(tcfg, params, device="cpu", **eng_kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        eng.run()
    finally:
        transformer._slots = slots
    return sum(drops)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX engine's unsharded results, the port's on each mesh."""
    jobs, refs = [], []
    for name, (arch, ckw, ekw, (n, lens), _) in CASES.items():
        jcfg, tcfg = _configs(arch, **ckw)
        w = jax.tree.map(np.asarray, _INIT(jcfg, jax.random.PRNGKey(0)))
        prompts = _prompts(n, lens, jcfg.vocab)
        refs.append((name, jcfg, w, ekw, prompts))
        jobs.append((name, "engine", dict(cfg=tcfg, params=bridge.tree_to_torch(w),
                                          prompts=prompts, max_new=MAX_NEW, **ekw)))
    jcfg, tcfg = _configs("smollm-135m")
    sw = jax.tree.map(np.asarray, _INIT(jcfg, jax.random.PRNGKey(0)))
    for name, (ekw, (n, lens), _) in SPECS.items():
        jobs.append((name, "spec", dict(cfg=tcfg, params=bridge.tree_to_torch(sw),
                                        prompts=_prompts(n, lens, jcfg.vocab),
                                        max_new=MAX_NEW, **SPEC, **ekw), [SPEC_MESH]))
    jobs.append(("cluster", "cluster", dict(cfg=tcfg, params=bridge.tree_to_torch(sw),
                                            mode="closed", max_new=MAX_NEW, **CLUSTER,
                                            **CLUSTER_KW), [CLUSTER_MESH]))

    def jax_side():
        want = {name: _run(JaxEngine(jcfg, w, **_jax_switches(ekw)), prompts)
                for name, jcfg, w, ekw, prompts in refs}
        jdcfg, jdw = jax_shared_trunk_draft(jcfg, sw, SPEC["n_draft"])
        for name, (ekw, (n, lens), _) in SPECS.items():
            eng = JaxSpecEngine(jcfg, sw, jdcfg, jdw, k=SPEC["k"], **_jax_switches(ekw))
            want[name] = _run(eng, _prompts(n, lens, jcfg.vocab)) + (
                (eng.spec_stats.iterations, eng.spec_stats.proposed,
                 eng.spec_stats.accepted, eng.spec_stats.bonus),)
        cl = jax_cluster.ServingCluster(jcfg, sw, n_replicas=CLUSTER["n_replicas"],
                                        router="round_robin", **CLUSTER_KW)
        reqs = jax_workload.zipf_mix_requests(
            np.random.default_rng(CLUSTER["seed"]), CLUSTER["n_requests"], jcfg.vocab,
            bands=CLUSTER["bands"], max_new_tokens=MAX_NEW)
        for r in reqs:
            cl.submit(r)
        cl.run()
        want["cluster"] = ({r.rid: list(r.out_tokens) for r in reqs},
                           {r.rid: r.finish_reason for r in reqs})
        name, _, w, ekw, prompts = next(r for r in refs if r[0] == "mixtral_compact")
        want["mixtral_decode_drops"] = _decode_drops(
            _configs("mixtral-8x7b", **CASES[name][1])[1], bridge.tree_to_torch(w),
            prompts, ekw)
        return want

    return _torch_mesh.run(tmp_path_factory.mktemp("dm"), MESHES + [CLUSTER_MESH], jobs,
                           meanwhile=jax_side)


_MESH_IDS = dict(ids=lambda m: f"world{m[0]}-model{m[1]}")


@pytest.mark.parametrize("mesh", MESHES, **_MESH_IDS)
@pytest.mark.parametrize("name", list(CASES))
def test_tokens_match_jax_unsharded(runs, name, mesh):
    want, got = runs
    out = got[mesh][name]
    tokens, reasons = want[name]
    assert out["tokens"] == tokens
    assert out["reasons"] == reasons
    assert out["state"]["split"] == CASES[name][4]


def test_mixtral_case_drops_tokens_at_decode(runs):
    """The capacity factor bites where the lanes' order matters."""
    want, _ = runs
    assert want["mixtral_decode_drops"] > 0


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _whole_cache(tcfg, max_batch, max_len):
    cache = api.init_cache(tcfg, max_batch, max_len, device="cpu")
    cache["index"] = torch.zeros((max_batch,), dtype=torch.int32)
    return cache


@pytest.mark.parametrize("mesh", MESHES, **_MESH_IDS)
@pytest.mark.parametrize("name", list(CASES))
def test_dense_leaves_take_cache_specs(runs, name, mesh):
    """Every leaf at the local shape `cache_specs` gives; the data dim
    (the slots, or one slot's length) halved, so the KV bytes of a rank
    are half those of the model-only placement."""
    _, got = runs
    arch, ckw, ekw, _, split = CASES[name]
    tcfg = _configs(arch, **ckw)[1]
    world, model = mesh
    shape = pmesh.MeshShape(("data", "model"), {"data": world // model, "model": model})
    whole = _whole_cache(tcfg, ekw["max_batch"], ekw["max_len"])
    specs = sharding.cache_specs(shape, whole, tcfg.kv_heads, ekw["max_batch"],
                                 n_heads=tcfg.n_heads)
    heads = {"segments": sharding.kv_head_specs(shape, whole["segments"], tcfg.kv_heads,
                                                n_heads=tcfg.n_heads)}
    want, model_only = [], 0
    for path, t in bridge.tree_paths(whole):
        want.append((path, sharding.local_shape(tuple(t.shape), _at(specs, path), shape)))
        if path[0] == "segments":
            model_only += int(np.prod(sharding.local_shape(tuple(t.shape), _at(heads, path),
                                                           shape)))
    out = got[mesh][name]["state"]
    assert out["cache"] == want
    dim = 1 if split == "rows" else 2
    for (path, local), (_, t) in zip(out["cache"], bridge.tree_paths(whole)):
        if path[0] == "segments":
            assert local[dim] * 2 == t.shape[dim], path
    seg_elems = sum(int(np.prod(s)) for p, s in out["cache"] if p[0] == "segments")
    # MLA's latent has its length over "model" besides (JAX's rule)
    extra = model if sharding.length_axes(shape, specs) == ("model",) else 1
    assert seg_elems * 2 * extra == model_only


@pytest.mark.parametrize("name", list(SPECS))
def test_spec_target_takes_the_dense_rule(runs, name):
    """The target's state split as the dense rule says (each row verifies
    its slots, or SP in the verify), the draft whole; tokens, finish
    reasons and spec stats equal the JAX spec engine's."""
    want, got = runs
    out = got[SPEC_MESH][name]
    tokens, reasons, stats = want[name]
    assert out["tokens"] == tokens and out["reasons"] == reasons
    assert out["spec_stats"] == stats
    assert out["state"]["split"] == SPECS[name][2]
    assert out["draft"]["split"] is None
    max_batch = SPECS[name][0]["max_batch"]
    assert all(shape[1] == max_batch for path, shape in out["draft"]["cache"]
               if path[0] == "segments")


def test_cluster_replicas_of_two_data_rows(runs):
    """Each replica's engine splits its dense slots over its own data
    group; every rank of the (4, 1) mesh ends with the same records, the
    tokens and finish reasons those of JAX's unsharded replicas."""
    want, got = runs
    out = got[CLUSTER_MESH]["cluster"]
    assert (out["tokens"], out["finish"]) == want["cluster"]
    ranks = out["ranks"]
    assert len(ranks) == CLUSTER_MESH[0] and all(r == ranks[0] for r in ranks[1:])
    # past the cluster's one all_gather a step, the engine's of its rows' logits
    assert out["counts"]["all_gather"] > out["stats"]["steps"]


def _stand_in(rank=1, data=2, model=1):
    return pmesh.Mesh(("data", "model"), {"data": data, "model": model}, rank,
                      torch.device("cpu"), {})


@pytest.mark.parametrize("arch,kw", [
    ("smollm-135m", dict(paged=True)),
    ("smollm-135m", dict(paged=True, kv_quant=True)),
    ("smollm-135m", dict(paged=False, kv_quant="dense")),
    ("rwkv6-3b", {}), ("recurrentgemma-2b", {}), ("whisper-base", dict(enc_len=16))],
    ids=["paged", "paged-int8", "dense-int8", "rwkv6", "rglru", "whisper"])
def test_other_states_keep_every_slot(arch, kw):
    """JAX splits only the bf16 / f32 dense rectangles over "data": a data
    rank of a (2, 1) mesh holds every slot of the paged pools (pages
    whole), the int8 rectangles and scales, and the recurrent and
    cross-attention leaves."""
    tcfg = configs.get_smoke_config(arch).replace(n_layers=2)
    mesh = _stand_in()
    params = api.init_params(tcfg, 0, device="cpu")
    eng = ServingEngine(tcfg, sharding.shard_params(params, mesh, tcfg), device="cpu",
                        max_batch=4, max_len=32, mesh=mesh, **kw)
    st = eng.state
    assert getattr(st, "split", None) is None
    if st.paged:
        whole = eng.pool.segments if not kw.get("kv_quant") else eng.pool.scales
        fresh = ServingEngine(tcfg, params, device="cpu", max_batch=4, max_len=32, **kw).pool
        ref = fresh.segments if not kw.get("kv_quant") else fresh.scales
        assert [tuple(t.shape) for _, t in bridge.tree_paths(whole)] == \
            [tuple(t.shape) for _, t in bridge.tree_paths(ref)]
        return
    if st.kind == "dense":
        leaves = bridge.tree_paths(st.cache["segments"]) + bridge.tree_paths(st.scales)
        assert all(t.shape[1] == 4 for _, t in leaves)
    else:
        assert all(t.shape[0] == 4 for _, t in bridge.tree_paths(st.cache["layers"]))
    assert st.cache["index"].shape == (4,)


@pytest.mark.parametrize("rank", [0, 1])
def test_dense_split_on_a_stand_in_rank(rank):
    """`DenseKVState.place` on rank `rank` of a (2, 1) stand-in: 2 of 4
    slots (its rows' slots local at 0, 1; the other row's None), or half
    of one slot's length; each `step_lanes` row width min(2, lanes), the
    lanes' order over the gathered rows JAX's `active + [active[0]] *
    pad`."""
    tcfg = configs.get_smoke_config("smollm-135m").replace(n_layers=2)
    mesh = _stand_in(rank)
    params = sharding.shard_params(api.init_params(tcfg, 0, device="cpu"), mesh, tcfg)
    eng = ServingEngine(tcfg, params, device="cpu", max_batch=4, decode_batch=3, max_len=32,
                        paged=False, mesh=mesh)
    st = eng.state
    assert st.split == "rows" and st.cache["segments"][0]["k"].shape[1] == 2
    assert [st.local_slot(b) for b in range(4)] == \
        ([0, 1, None, None] if rank == 0 else [None, None, 0, 1])
    lanes = st.step_lanes([1, 3, 1])        # one active slot a row, one padding lane
    lo = 2 * rank
    assert lanes.slots == [lo + 1, lo] and lanes.n == 1
    assert lanes.rows.tolist() == [[0], [1]][rank] + [0]
    assert lanes.order.tolist() == [0, 2, 0]
    lanes = st.step_lanes([2, 3, 2])        # row 0 holds no lane: a stand-in row
    assert (lanes.n, lanes.slots) == ((0, [0, 0]) if rank == 0 else (2, [2, 3]))
    assert lanes.order.tolist() == [2, 3, 2]
    one = ServingEngine(tcfg, params, device="cpu", max_batch=1, max_len=32, paged=False,
                        mesh=mesh).state
    assert one.split == "seq" and one.cache["segments"][0]["k"].shape[2] == 16
    assert one.local_slot(0) == 0
