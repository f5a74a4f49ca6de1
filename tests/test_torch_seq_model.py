"""A decode cache split along its length over "model", the port's against
the JAX package's, on the CPU, float32.

* `sharding.cache_specs` equals JAX's `cache_shardings` leaf for leaf
  for every arch x decode shape (the registry's, skipped cells too) on
  the single-pod (16, 16) and the two-pod (2, 16, 16) mesh, with
  `seq_shard` both ways: MLA's latent (L, B, C, D) has its length over
  "model", and with `seq_shard` so has a {k, v} cache whose KV heads do
  not split (meta shapes against JAX's `AbstractMesh`; nothing traced).
* `ServingEngine(mesh=)` with the dense state on a (2, 2) ("data",
  "model") gloo mesh of 4 ranks, smoke configs:
  - deepseek-v3 (MLA, 4 heads split over "model"): the latent's length
    over "model", the slots whole (3 do not split over "data"); each
    rank gathers the absorbed queries, scores every head against its
    block of the latent and keeps its own heads after the combine;
  - mixtral-8x7b with one KV head (its heads cannot split) and
    `cache_seq_shard`: the sliding-window ring's length over "model",
    the 4 slots over "data"; two prompts longer than the 64-slot window,
    and decode steps that wrap the ring;
  - smollm-135m with one KV head, `cache_seq_shard` and `gqa_einsum`
    (the grouped contraction).
  Greedy tokens equal the JAX engine's (`max_batch >= 2`: JAX's dense
  state splices nothing with one slot); every decode step's logits are within 1e-5 of the
  unsplit port engine's (one process, no mesh); each rank's cache
  leaves hold C / 2 of the length.
"""
import concurrent.futures

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import _torch_mesh
from repro import configs as jax_configs
from repro.launch import specs as jax_specs
from repro.models import api as jax_api
from repro.parallel import sharding as jax_sharding
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.launch import specs
from repro_torch.launch.dryrun import production_shape
from repro_torch.parallel import sharding
from repro_torch.parallel.mesh import MeshShape
from repro_torch.serving.engine import Request, ServingEngine

TOL = 1e-5
DECODE_CELLS = [(a, s) for a, s in jax_configs.cells(include_skipped=True)
                if jax_configs.SHAPES[s].kind == "decode"]
F32 = dict(dtype="float32", param_dtype="float32")
# name -> (arch, config switches, engine switches, prompt lengths)
CASES = {
    "deepseek_latent": ("deepseek-v3-671b", dict(n_layers=2),
                        dict(max_batch=3, decode_batch=2, max_len=32), (3, 14, 7, 20, 9)),
    "mixtral_ring": ("mixtral-8x7b", dict(n_layers=2, kv_heads=1, cache_seq_shard=True),
                     dict(max_batch=4, decode_batch=4, max_len=96), (70, 12, 66, 30, 9)),
    "smollm_einsum": ("smollm-135m", dict(n_layers=2, kv_heads=1, cache_seq_shard=True,
                                          gqa_einsum=True),
                      dict(max_batch=3, decode_batch=2, max_len=32, paged=False),
                      (3, 14, 7, 20, 9)),
}
MAX_NEW = {"deepseek_latent": 6, "mixtral_ring": 12, "smollm_einsum": 6}
MESH = (4, 2)                        # (world, model axis): ("data", "model") (2, 2)


def _spec_leaves(tree, at=""):
    """('/'-joined path, spec) of a tree of specs (tuples are leaves)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(at, tree)]
    return [e for k, v in items for e in _spec_leaves(v, f"{at}/{k}" if at else str(k))]


def _norm(spec, ndim):
    out = [() if a is None else ((a,) if isinstance(a, str) else tuple(a)) for a in spec]
    return out + [()] * (ndim - len(out))


@pytest.mark.parametrize("seq_shard", [False, True], ids=["plain", "seq_shard"])
@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch,shape_name", DECODE_CELLS)
def test_cache_specs_equal_jax(arch, shape_name, mesh_kind, seq_shard):
    dims, names = production_shape(mesh_kind == "multi")
    jmesh, tmesh = AbstractMesh(dims, names), MeshShape(names, dict(zip(names, dims)))
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    shape = configs.SHAPES[shape_name]
    _, cache = specs.decode_specs(cfg, shape)
    _, jcache = jax_specs.decode_specs(jcfg, jax_configs.SHAPES[shape_name])
    got = dict(_spec_leaves(sharding.cache_specs(
        tmesh, cache, cfg.kv_heads, shape.global_batch, seq_shard, n_heads=cfg.n_heads)))
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(jax_sharding.cache_shardings(
            jmesh, jcache, jcfg.kv_heads, shape.global_batch, seq_shard=seq_shard))[0]:
        keys = [getattr(q, "key", getattr(q, "idx", None)) for q in path]
        want["/".join(map(str, keys))] = s.spec
    leaves = {sharding.path_str(p): t for p, t in bridge.tree_paths(cache)}
    assert set(got) == set(want) == set(leaves)
    for path, spec in got.items():
        nd = leaves[path].dim()
        assert _norm(spec, nd) == _norm(want[path], nd), path
    if jcfg.use_mla and shape.global_batch > 1:
        latent = got["segments/0/latent"]
        assert latent[2] == "model"


def _configs(name):
    arch, kw, _, _ = CASES[name]
    return (jax_configs.get_smoke_config(arch).replace(**F32, **kw),
            configs.get_smoke_config(arch).replace(**F32, **kw))


def _prompts(name, vocab):
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in CASES[name][3]]


def _jax_tokens(name, w):
    jcfg, _ = _configs(name)
    kw = dict(CASES[name][2])
    kw.setdefault("paged", False)
    eng = JaxEngine(jcfg, w, **kw)
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW[name])
            for i, p in enumerate(_prompts(name, jcfg.vocab))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out_tokens for r in reqs]


def _unsplit(name, w):
    """Tokens and every decode step's logits of the port's engine in this
    process, no mesh."""
    _, tcfg = _configs(name)
    kw = dict(CASES[name][2])
    kw.setdefault("paged", False)
    eng = ServingEngine(tcfg, bridge.tree_to_torch(w), device="cpu", **kw)
    seen: list = []
    eng.state.decode = _torch_mesh._recording(eng.state.decode, seen)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW[name])
            for i, p in enumerate(_prompts(name, tcfg.vocab))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return {"tokens": [r.out_tokens for r in reqs], "logits": seen,
            "clen": next(iter(eng.state.cache["segments"][0].values())).shape[2]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs, refs = [], []
    for name in CASES:
        jcfg, tcfg = _configs(name)
        w = jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))
        kw = dict(CASES[name][2])
        kw.setdefault("paged", False)
        jobs.append((name, "engine", dict(cfg=tcfg, params=bridge.tree_to_torch(w),
                                          prompts=_prompts(name, tcfg.vocab),
                                          max_new=MAX_NEW[name], record_logits=True, **kw)))
        refs.append((name, w))

    def meanwhile():
        with concurrent.futures.ThreadPoolExecutor(len(refs)) as pool:
            futs = {n: pool.submit(_jax_tokens, n, w) for n, w in refs}
            unsplit = {n: _unsplit(n, w) for n, w in refs}
            return {n: (f.result(), unsplit[n]) for n, f in futs.items()}

    return _torch_mesh.run(tmp_path_factory.mktemp("seq_model"), [MESH], jobs,
                           meanwhile=meanwhile)


@pytest.mark.parametrize("name", list(CASES))
def test_split_length_tokens_equal_jax(runs, name):
    want, got = runs
    assert got[MESH][name]["tokens"] == want[name][0]
    assert got[MESH][name]["tokens"] == want[name][1]["tokens"]


@pytest.mark.parametrize("name", list(CASES))
def test_split_length_logits_equal_unsplit(runs, name):
    want, got = runs
    split, whole = got[MESH][name]["logits"], want[name][1]["logits"]
    assert len(split) == len(whole) > 0
    for a, b in zip(split, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_split_length_rank_holds_half(runs, name):
    want, got = runs
    st = got[MESH][name]["state"]
    assert st["length"] == ("model",)
    assert st["split"] == ("rows" if CASES[name][2]["max_batch"] % 2 == 0 else None)
    clen = want[name][1]["clen"]
    for path, shape in st["cache"]:
        if path[-1] in ("k", "v", "latent"):
            assert shape[2] == clen // 2, (path, shape)
