"""Serving every family on a mesh: the port's tensor-parallel rwkv6, RG-LRU
hybrid and whisper against the JAX package's unsharded models, on the
CPU.

Gloo ranks spawned on the CPU (`_torch_mesh.run`, one spawn a mesh) build
meshes (1, 2) and (2, 2) ("data", "model") and run, on float32 weights
the JAX `init_params` drew:

* tiny rwkv6 (4 heads of 16), rglru with one attention layer in three
  (its 4 / 2 heads split over 2 ranks), the same with MQA (4 / 1 heads:
  the attention stays replicated, as recurrentgemma-2b's 10 / 1 does)
  and whisper (vocab 129, which does not split: the embedding stays
  replicated, as whisper-base's 51,865 does): `forward`, the prefill's
  last logits and two greedy `decode_step`s within 2e-4 of JAX's
  unsharded run, and the collectives each rank called, layer by layer;
* the port's `ServingEngine(mesh=...)` over the recurrent and
  cross-attention states (decode_batch 2 of 3 slots, whisper's requests
  with frames shorter and longer than its encoder window, and without):
  greedy tokens and finish reasons equal to the JAX engine's.

In one process, with stand-in meshes: `shard_params` of each family
reassembles bit for bit, `api.init_params(mesh=)` draws the same blocks,
`check_shards` takes them and refuses the whole tree, and the states'
`place` allocates each leaf at the local shape `layer_state_specs` gives.
"""
import jax
import numpy as np
import pytest
import torch

import _torch_mesh
from repro.models import api as jax_api
from repro.models.config import ModelConfig as JaxConfig
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import mesh as pmesh
from repro_torch.parallel import sharding
from repro_torch.serving.state import CrossAttnState, RecurrentState

TOL = 2e-4
BASE = dict(d_model=64, n_heads=4, kv_heads=4, head_dim=16, d_ff=128, vocab=128,
            dtype="float32", param_dtype="float32", scan_layers=False)
CONFIGS = {
    "rwkv6": dict(BASE, family="rwkv6", n_layers=2, wkv_lora=8),
    "rglru": dict(BASE, family="rglru", n_layers=3, kv_heads=2, lru_width=64, attn_every=3,
                  window=16),
    "rglru_mqa": dict(BASE, family="rglru", n_layers=3, kv_heads=1, lru_width=64,
                      attn_every=3, window=16),
    "whisper": dict(BASE, family="whisper", n_layers=2, n_enc_layers=2, vocab=129,
                    norm="layernorm", swiglu=False, frontend="audio"),
}
ENGINE_KW = dict(max_batch=3, decode_batch=2, max_len=32)
ENC_LEN = 16
MAX_NEW = 6
MESHES = [(2, 2), (4, 2)]           # (world, model axis): (1, 2) and (2, 2)
_INIT = jax.jit(jax_api.init_params, static_argnums=0)
_FORWARD = jax.jit(jax_api.forward, static_argnums=0)
_PREFILL = jax.jit(jax_api.prefill, static_argnums=(0, 3))
_DECODE = jax.jit(jax_api.decode_step, static_argnums=0)


def _weights(name):
    jcfg = JaxConfig(**CONFIGS[name])
    return jcfg, jax.tree.map(np.asarray, _INIT(jcfg, jax.random.PRNGKey(0)))


def _batch(name):
    toks = np.random.default_rng(3).integers(0, 128, size=(2, 12))
    batch = {"tokens": toks}
    if CONFIGS[name]["family"] == "whisper":
        batch["embeds"] = np.random.default_rng(4).standard_normal((2, 10, 64)).astype(
            np.float32)
    return batch


def _prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, 128, size=int(n)).astype(np.int32) for n in (3, 14, 7, 20, 9)]


def _frames(name):
    """Whisper's frames a request: shorter and longer than the window, and none."""
    if CONFIGS[name]["family"] != "whisper":
        return None
    return [None if n == 0 else
            np.random.default_rng(i).standard_normal((n, 64)).astype(np.float32)
            for i, n in enumerate((5, 0, 40, 12, 3))]


def _jax_forward(jcfg, w, batch, max_len):
    jb = {k: jax.numpy.asarray(v, dtype=jax.numpy.int32 if k == "tokens" else None)
          for k, v in batch.items()}
    fwd = np.asarray(_FORWARD(jcfg, w, jb))
    last, cache = _PREFILL(jcfg, w, jb, max_len)
    steps, tok = [], jax.numpy.argmax(last[:, -1], -1)[:, None].astype(jax.numpy.int32)
    for _ in range(2):
        lg, cache = _DECODE(jcfg, w, tok, cache)
        steps.append(np.asarray(lg))
        tok = jax.numpy.argmax(lg[:, -1], -1)[:, None].astype(jax.numpy.int32)
    return {"forward": fwd, "prefill": np.asarray(last), "decode": np.stack(steps)}


def _enc(name):
    return dict(enc_len=ENC_LEN) if CONFIGS[name]["family"] == "whisper" else {}


def _jax_engine(jcfg, w, name):
    eng = JaxEngine(jcfg, w, **ENGINE_KW, **_enc(name))
    frames = _frames(name)
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW,
                       frames=None if frames is None else frames[i])
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out_tokens for r in reqs], [r.finish_reason for r in reqs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's unsharded results (computed while the ranks run) and the
    port's on each mesh, by mesh."""
    jobs, weights = [], {name: _weights(name) for name in CONFIGS}
    for name, (_, w) in weights.items():
        tcfg, tw = ModelConfig(**CONFIGS[name]), bridge.tree_to_torch(w)
        jobs.append((name, "family_forward", dict(
            cfg=tcfg, params=tw, max_len=32,
            batch={k: torch.as_tensor(v) for k, v in _batch(name).items()})))
        jobs.append((f"engine-{name}", "engine", dict(
            cfg=tcfg, params=tw, prompts=_prompts(), max_new=MAX_NEW, frames=_frames(name),
            **ENGINE_KW, **_enc(name))))

    def jax_side():
        want = {}
        for name, (jcfg, w) in weights.items():
            want[name] = _jax_forward(jcfg, w, _batch(name), 32)
            want[f"engine-{name}"] = _jax_engine(jcfg, w, name)
        return want

    return _torch_mesh.run(tmp_path_factory.mktemp("fam"), MESHES, jobs, meanwhile=jax_side)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"world{m[0]}-model{m[1]}")
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_and_decode_match_jax_unsharded(runs, name, mesh):
    want, got = runs
    out = got[mesh][name]
    for key in ("forward", "prefill", "decode"):
        np.testing.assert_allclose(out[key].numpy(), want[name][key],
                                   rtol=TOL, atol=TOL, err_msg=f"{name} {key}")


# collectives a model call (forward, prefill, two decodes: 4 calls; the
# encoder runs in 2), by family: rwkv6 a layer 2 all_reduce (time mix,
# channel mix) + 1 all_gather (receptance); rglru a recurrent layer 1 +
# 1 (w_out, the conv output), an attention layer 1 where it shards, an
# MLP 1; whisper 2 an encoder layer, 3 a decoder layer; the vocab-split
# embedding 1 all_reduce, its logits 1 all_gather
COLLECTIVES = {"rwkv6": (4 * (1 + 2 * 2), 4 * (1 + 2)),
               "rglru": (4 * (1 + 2 + 1 + 3), 4 * (1 + 2)),
               "rglru_mqa": (4 * (1 + 2 + 3), 4 * (1 + 2)),
               "whisper": (2 * 2 * 2 + 4 * 3 * 2, 0)}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"world{m[0]}-model{m[1]}")
@pytest.mark.parametrize("name", list(CONFIGS))
def test_collectives_per_layer(runs, name, mesh):
    _, got = runs
    reduce, gather = COLLECTIVES[name]
    assert got[mesh][name]["counts"] == {"all_reduce": reduce, "all_gather": gather,
                                         "all_to_all": 0, "broadcast": 0}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"world{m[0]}-model{m[1]}")
@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_tokens_match_jax_unsharded(runs, name, mesh):
    want, got = runs
    out = got[mesh][f"engine-{name}"]
    tokens, reasons = want[f"engine-{name}"]
    assert out["tokens"] == tokens
    assert out["reasons"] == reasons
    assert out["counts"]["broadcast"] == out["prefills"] + out["decode_steps"]


def _mesh_ranks(d, m):
    shape = {"data": d, "model": m}
    return [pmesh.Mesh(("data", "model"), shape, r, torch.device("cpu"), {})
            for r in range(d * m)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shard_params_reassembles_and_init_draws_the_blocks(name):
    cfg = ModelConfig(**CONFIGS[name])
    params = api.init_params(cfg, 0, device="cpu")
    ranks = _mesh_ranks(1, 2)
    shards = [sharding.shard_params(params, m, cfg) for m in ranks]
    specs = sharding.param_spec_map(ranks[0], params, cfg=cfg)
    n_split = 0
    for path, full in sharding._leaves_with_paths(params):
        spec = specs[sharding.path_str(path)]
        parts = []
        for sp in shards:
            for p in path:
                sp = sp[p]
            parts.append(sp)
        dims = [i for i, a in enumerate(spec) if a is not None]
        if dims:
            n_split += 1
            assert torch.equal(torch.cat(parts, dims[0]), full), path
        else:
            assert all(torch.equal(x, full) for x in parts), path
    assert n_split > 0
    for m, sp in zip(ranks, shards):
        drawn = api.init_params(cfg, 0, device="cpu", mesh=m)
        got, want = bridge.tree_paths(drawn), bridge.tree_paths(sp)
        assert [k for k, _ in got] == [k for k, _ in want]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
        sharding.check_shards(cfg, sp, m)
        with pytest.raises(ValueError, match="not this rank's shards"):
            sharding.check_shards(cfg, params, m)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_place_allocates_local_shapes(name):
    cfg = ModelConfig(**CONFIGS[name])
    mesh = _mesh_ranks(1, 2)[1]
    cls = CrossAttnState if cfg.family == "whisper" else RecurrentState
    st = cls(cfg, 3, 32, decode_batch=2, device=torch.device("cpu"))
    whole = [{k: tuple(v.shape) for k, v in lc.items()} for lc in st.cache["layers"]]
    st.place(mesh)
    plan = sharding.tp_plan(cfg, mesh)
    for lc, shapes in zip(st.cache["layers"], whole):
        for key, x in lc.items():
            want = list(shapes[key])
            if key in ("h", "conv") and plan.rec:
                want[-1] //= 2
            elif (key == "wkv" and plan.attn) or (key in ("k", "v", "ck", "cv") and plan.attn):
                want[1 if key == "wkv" else 2] //= 2
            assert tuple(x.shape) == tuple(want), (key, x.shape, want)
            assert not x.any()
    assert tuple(st.cache["index"].shape) == (3,)
