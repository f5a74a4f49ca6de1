"""The port's sharding rules (`repro_torch.parallel.sharding`) and meshes
(`repro_torch.parallel.mesh`, `repro_torch.launch.mesh`) against the JAX
package's, on the CPU.

* The rule table: for all ten archs at full size (`jax.eval_shape` of
  the JAX `init_params`) and a stub mesh of shape {"data": 2, "model":
  4}, the port's `param_spec_map` without a config equals JAX's
  `param_spec_map` leaf for leaf (and with fsdp); with the config, it
  differs only on the listed leaves: an attention whose heads do not
  split whole over 4 is replicated (smollm 9 / 3, qwen2-vl 12 / 2,
  recurrentgemma 10 / 1), and the QKV biases (qwen2.5's, whisper's q
  and v) shard with their projections' columns.
* `tp_plan` agrees with the specs it stands for.
* `shard_params` over (2, 2) and (1, 4) meshes reassembles every leaf
  bit for bit; `api.init_params(mesh=)` draws the same blocks, bit for
  bit; `check_shards` takes the blocks and refuses the whole tree.
* The cache rules: KV heads over "model" on whole heads, the dense batch
  over "data" (`cache_specs`), the engine's rectangles and pages never
  split (`kv_head_specs`), MLA latents replicated.
* `replica_meshes`' two errors with JAX's messages, its splits of a
  `MeshShape`; `make_production_mesh`'s shape; `make_host_mesh` refusing
  NCCL with more ranks than cards, naming gloo.
"""
import types

import jax
import pytest
import torch

from repro import configs as jax_configs
from repro.models import api as jax_api
from repro.parallel import sharding as jax_sharding
from repro_torch import bridge, configs
from repro_torch.launch import mesh as tmesh
from repro_torch.parallel import mesh as pmesh
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding

STUB = types.SimpleNamespace(shape={"data": 2, "model": 4})
# leaves (by their last two path parts) whose spec the whole-heads rule
# (and the bias rule) makes differ from GSPMD's, at a model axis of 4
DEPARTURES = {
    "smollm-135m": {"attn/wq", "attn/wk", "attn/wv", "attn/wo"},        # 9 / 3 heads
    "qwen2-vl-2b": {"attn/wq", "attn/wk", "attn/wv", "attn/wo"},        # 12 / 2
    "recurrentgemma-2b": {"attn/wq", "attn/wk", "attn/wv", "attn/wo"},  # 10 / 1
    "qwen2.5-32b": {"attn/bq", "attn/bk", "attn/bv"},                   # biases shard
    "whisper-base": {"attn/bq", "attn/bv", "self_attn/bq", "self_attn/bv",
                     "cross_attn/bq", "cross_attn/bv"},
}


@pytest.fixture(scope="module")
def shapes():
    key = jax.random.PRNGKey(0)
    return {arch: jax.eval_shape(lambda c=jax_configs.get_config(arch): jax_api.init_params(c, key))
            for arch in configs.ARCH_IDS}


def _jax_map(mesh, tree, fsdp=False):
    return {k: tuple(v) for k, v in jax_sharding.param_spec_map(mesh, tree, fsdp).items()}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_rule_table_matches_jax(shapes, arch):
    tree = shapes[arch]
    for fsdp in (False, True):
        assert sharding.param_spec_map(STUB, tree, fsdp) == _jax_map(STUB, tree, fsdp)
    want = _jax_map(STUB, tree)
    got = sharding.param_spec_map(STUB, tree, cfg=configs.get_config(arch))
    assert got.keys() == want.keys()
    differ = {k for k in want if got[k] != want[k]}
    assert {"/".join(k.split("/")[-2:]) for k in differ} == DEPARTURES.get(arch, set())
    for k in differ:
        if k.split("/")[-1].startswith("b"):      # a bias: sharded, JAX replicates
            assert all(a is None for a in want[k]) and "model" in got[k], k
        else:                                      # split heads: replicated
            assert all(a is None for a in got[k]) and "model" in want[k], k


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if configs.get_config(a).family == "transformer"])
def test_tp_plan_follows_the_specs(shapes, arch):
    cfg = configs.get_config(arch)
    for model in (2, 4):
        mesh = types.SimpleNamespace(shape={"data": 1, "model": model})
        spec = sharding.param_spec_map(mesh, shapes[arch], cfg=cfg)
        plan = sharding.tp_plan(cfg, mesh)
        seg = "segments/0/kind_" + ("moe" if cfg.use_moe and not cfg.first_dense_layers
                                    else "dense")
        attn = seg + ("/attn/wuq" if cfg.use_mla else "/attn/wq")
        assert plan.attn == ("model" in spec[attn]), attn
        assert plan.vocab == ("model" in spec["embed"])
        if not cfg.use_moe or cfg.first_dense_layers:
            assert plan.mlp == ("model" in spec[seg + "/mlp/w_in"])
        if cfg.use_moe:
            moe = f"segments/{len(shapes[arch]['segments']) - 1}/kind_moe/moe"
            ein = spec[moe + "/experts_in"]
            assert plan.moe == ("ep" if ein[1] == "model" else
                                "f" if ein[-1] == "model" else "")
            if cfg.n_shared_experts:
                assert plan.shared == ("model" in spec[moe + "/shared/w_in"])


def _mesh_ranks(data, model):
    shape = {"data": data, "model": model}
    return [pmesh.Mesh(("data", "model"), shape, r, torch.device("cpu"), {})
            for r in range(data * model)]


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)], ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("kw", [dict(), dict(n_experts=4, top_k=2, n_shared_experts=1,
                                             first_dense_layers=1, qkv_bias=True),
                                dict(mla_q_rank=32, mla_kv_rank=16, mla_rope_dim=8,
                                     kv_heads=4, mtp=True)],
                         ids=["gqa", "moe", "mla"])
def test_shard_params_reassembles_bit_exact(kw, grid):
    cfg = ModelConfig(**dict(dict(n_layers=2, d_model=64, n_heads=4, kv_heads=2,
                                  head_dim=16, d_ff=128, vocab=128, dtype="float32",
                                  param_dtype="float32"), **kw))
    params = api.init_params(cfg, 0, device="cpu")
    ranks = _mesh_ranks(*grid)
    shards = [sharding.shard_params(params, m, cfg) for m in ranks]
    specs = sharding.param_spec_map(ranks[0], params, cfg=cfg)
    n_split = 0
    for path, full in sharding._leaves_with_paths(params):
        spec = specs[sharding.path_str(path)]
        out = torch.full_like(full, float("nan"))
        for m, sp in zip(ranks, shards):
            local = sp
            for p in path:
                local = local[p]
            assert local.shape == sharding.local_shape(full.shape, spec, m)
            idx = [slice(None)] * full.dim()
            for dim, a in enumerate(spec):
                if a is not None:
                    size = full.shape[dim] // sharding.axis_size(m, a)
                    idx[dim] = slice(m.axis_rank(a) * size, (m.axis_rank(a) + 1) * size)
            out[tuple(idx)] = local
        n_split += any(a is not None for a in spec)
        assert torch.equal(out, full), path
    assert n_split > 0
    for m, sp in zip(ranks, shards):
        drawn = api.init_params(cfg, 0, mesh=m)
        got, want = bridge.tree_paths(drawn), bridge.tree_paths(sp)
        assert [k for k, _ in got] == [k for k, _ in want]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
        sharding.check_shards(cfg, sp, m)
        with pytest.raises(ValueError, match="not this rank's shards"):
            sharding.check_shards(cfg, params, m)


def test_cache_rules():
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    cache = {"segments": [{"k": torch.empty(2, 4, 16, 2, 8), "v": torch.empty(2, 4, 16, 2, 8)},
                          {"latent": torch.empty(1, 4, 16, 24)}],
             "index": torch.empty(4)}
    specs = sharding.cache_specs(mesh, cache, kv_heads=2, batch_size=4, n_heads=4)
    assert specs["segments"][0]["k"] == (None, ("data",), None, "model", None)
    # MLA's latent: its length over "model", as JAX's cache_shardings puts it
    assert specs["segments"][1]["latent"] == (None, ("data",), "model", None)
    assert specs["index"] == (("data",),)
    # the engine's rectangles: KV heads only, slots whole; heads that do
    # not split whole stay replicated
    segs = cache["segments"]
    assert sharding.kv_head_specs(mesh, segs, kv_heads=2, n_heads=4)[0]["k"] == \
        (None, None, None, "model", None)
    assert sharding.kv_head_specs(mesh, segs, kv_heads=2, n_heads=3)[0]["k"] == (None,) * 5
    # one long sequence: its length over "data" (SP); seq_shard: over "model"
    one = {"segments": [{"k": torch.empty(2, 1, 16, 3, 8)}]}
    assert sharding.cache_specs(mesh, one, 3, 1)["segments"][0]["k"] == \
        (None, None, ("data",), None, None)
    assert sharding.cache_specs(types.SimpleNamespace(shape={"model": 2}), one, 3, 1,
                                seq_shard=True)["segments"][0]["k"] == \
        (None, None, "model", None, None)
    pools = [{"k": torch.empty(2, 9, 16, 2, 8)}, {"latent": torch.empty(2, 9, 16, 24)}]
    pspec = sharding.kv_head_specs(mesh, pools, kv_heads=2, n_heads=4)
    assert pspec == [{"k": (None, None, None, "model", None)}, {"latent": (None,) * 4}]
    assert sharding.local_cache_shapes(mesh, pools, pspec)[0]["k"] == (2, 9, 16, 1, 8)
    placed = sharding.place(mesh, pools, pspec)
    assert placed[0]["k"].shape == (2, 9, 16, 1, 8) and not placed[0]["k"].any()
    assert sharding.batch_spec(mesh, 4, 3) == (("data",), None, None)
    assert sharding.batch_spec(mesh, 3, 2) == (None, None)


def test_replica_meshes_and_mesh_shapes():
    assert sharding.replica_meshes(None, 3) == [None] * 3
    full = pmesh.MeshShape(("data", "model"), {"data": 4, "model": 2})
    assert sharding.replica_meshes(full, 1) == [full]
    halves = sharding.replica_meshes(full, 2)
    assert [h.shape for h in halves] == [{"data": 2, "model": 2}] * 2
    # JAX's two errors, word for word, on meshes of the one CPU device
    for jmesh, tm in (
            (jax.make_mesh((1,), ("model",)), pmesh.MeshShape(("model",), {"model": 1})),
            (jax.make_mesh((1, 1), ("data", "model")),
             pmesh.MeshShape(("data", "model"), {"data": 1, "model": 1}))):
        with pytest.raises(ValueError) as want:
            jax_sharding.replica_meshes(jmesh, 2)
        with pytest.raises(ValueError) as got:
            sharding.replica_meshes(tm, 2)
        assert str(got.value) == str(want.value)
    prod = tmesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}


def test_host_mesh_refuses_nccl_past_the_cards(monkeypatch):
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tmesh.dist, "get_backend", lambda *a: "nccl")
    monkeypatch.setattr(tmesh.dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(tmesh.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="gloo"):
        tmesh.make_host_mesh(2, backend="nccl")
    with pytest.raises(ValueError, match="not 'gloo'"):
        tmesh.make_host_mesh(2, backend="gloo")
