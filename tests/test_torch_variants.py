"""The transformer variants of the PyTorch/CUDA port on the CPU against the
JAX package, float32, on the same transferred weights (logits within
1e-4, greedy tokens equal):

* the registry holds the JAX package's ten archs, the four added here
  field for field (full and smoke configs);
* h2o-danube-1.8b's smoke config (window 64): forward, prefill (ring
  cache included) and decode past the window, and the served tokens of
  the dense-state engine with prompts and streams past the window;
* M-RoPE: `mrope_tables` + `apply_rope` against the JAX `apply_mrope`
  with three differing position streams; qwen2-vl-2b's forward with a
  vision `embeds` prefix and explicit positions; its prefill and decode;
* qwen2-vl-2b's served tokens on the paged gather route, the pool route
  and int8 KV, against the JAX paged engine; `decode_window` with M-RoPE.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import api as jax_api
from repro.models import common as jax_common
from repro.models import transformer as jax_tf
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.launch.serve import serve
from repro_torch.models import api, transformer
from repro_torch.models.common import apply_rope, mrope_tables
from repro_torch.serving.engine import Request, ServingEngine

NEW_ARCHS = ("h2o-danube-1.8b", "qwen2-vl-2b", "deepseek-v3-671b", "whisper-base")
TOL = dict(rtol=1e-4, atol=1e-4)
POOL = dict(attn_impl="flash")

_jax_forward = jax.jit(jax_tf.forward, static_argnums=(0,))
_jax_prefill = jax.jit(jax_tf.prefill, static_argnums=(0, 3))
_jax_decode = jax.jit(jax_tf.decode_step, static_argnums=(0,))


def _cfgs(arch, **kw):
    return (jax_configs.get_smoke_config(arch).replace(**kw),
            configs.get_smoke_config(arch).replace(**kw))


@functools.lru_cache(maxsize=None)
def _weights(jcfg, seed=0):
    """JAX init_params as a numpy tree, drawn once a config (the bridge
    copies it, so no test writes into it); QKV biases (zero at init) get
    random values so the bias path is exercised."""
    tree = jax.tree.map(np.asarray, jax.jit(jax_api.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for seg in tree["segments"]:
        attn = next(iter(seg.values()))["attn"]
        for name in ("bq", "bk", "bv"):
            if name in attn:
                attn[name] = (0.1 * rng.standard_normal(attn[name].shape)).astype(np.float32)
    return tree


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _prompts(vocab, lens, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in lens]


def _serve_both(jcfg, tcfg, w, prompts, max_new, **kw):
    """Token streams, finish reasons and stats of the JAX engine and the
    port's on the same weights and prompts; returns the port's engine."""
    jeng = JaxEngine(jcfg, w, **kw)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    teng = ServingEngine(tcfg, bridge.tree_to_torch(w), device="cpu", **kw)
    treqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    serve(teng, treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.finish_reason for r in treqs] == [r.finish_reason for r in jreqs]
    for key in ("decode_steps", "prefills", "tokens_out", "preemptions", "rejected"):
        assert teng.stats[key] == jeng.stats[key], key
    return teng


# -- registry -----------------------------------------------------------------

def test_registry_holds_every_jax_arch():
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_match_jax_registry(arch):
    for get_j, get_t in ((jax_configs.get_config, configs.get_config),
                         (jax_configs.get_smoke_config, configs.get_smoke_config)):
        assert dataclasses.asdict(get_t(arch)) == dataclasses.asdict(get_j(arch))


# -- h2o-danube-1.8b ------------------------------------------------------------

@pytest.mark.parametrize("plen", [40, 150])
def test_danube_forward_prefill_decode_match_jax(plen):
    """Window 64, cache 96 -> a ring of 64: a 150-token prompt wraps it
    (rolled placement), and both prompts decode past the window."""
    jcfg, tcfg = _cfgs("h2o-danube-1.8b")
    w = _weights(jcfg)
    params = bridge.tree_to_torch(w)
    toks = np.random.default_rng(plen).integers(0, jcfg.vocab, size=(2, plen)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    _close(transformer.forward(tcfg, params, tt), _jax_forward(jcfg, w, jnp.asarray(toks)))
    lj, cj = _jax_prefill(jcfg, w, jnp.asarray(toks), 96)
    lt, ct = transformer.prefill(tcfg, params, tt, 96)
    _close(lt, lj)
    for key in ("k", "v"):
        _close(ct["segments"][0][key], cj["segments"][0][key])
    nxt = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(30):
        lj, cj = _jax_decode(jcfg, w, jnp.asarray(nxt), cj)
        lt, ct = transformer.decode_step(tcfg, params, torch.from_numpy(nxt).long(), ct)
        _close(lt, lj)
        nxt = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)


def test_danube_engine_matches_jax():
    """Dense KV state (the window rules out paging); prompts of 70-110
    tokens wrap the 64-slot ring, and every stream decodes past it."""
    jcfg, tcfg = _cfgs("h2o-danube-1.8b")
    teng = _serve_both(jcfg, tcfg, _weights(jcfg),
                       _prompts(jcfg.vocab, (70, 12, 110, 90, 33)), 24,
                       max_batch=3, max_len=160, decode_batch=2)
    assert teng.state.kind == "dense" and not teng.paged
    assert teng.state.cache["segments"][0]["k"].shape[2] == 64


# -- M-RoPE ---------------------------------------------------------------------

def test_mrope_tables_match_jax_apply_mrope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos3 = rng.integers(0, 500, size=(3, 2, 7)).astype(np.int32)
    want = jax_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, (4, 6, 6))
    rope = mrope_tables(torch.from_numpy(pos3).long(), 32, 1e6, (4, 6, 6))
    got = apply_rope(torch.from_numpy(x), rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_qwen2_vl_forward_with_vision_prefix_matches_jax():
    """An `embeds` prefix of 6 patch embeddings before 10 text tokens,
    with explicit three-stream positions (a 2 x 3 patch grid at t 0,
    then text positions on all three streams)."""
    jcfg, tcfg = _cfgs("qwen2-vl-2b")
    w = _weights(jcfg)
    params = bridge.tree_to_torch(w)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, size=(2, 10)).astype(np.int32)
    emb = (0.5 * rng.standard_normal((2, 6, jcfg.d_model))).astype(np.float32)
    grid = np.stack([np.zeros(6), np.repeat(np.arange(2), 3), np.tile(np.arange(3), 2)])
    text = np.broadcast_to(np.arange(3, 13), (3, 10))
    pos3 = np.broadcast_to(np.concatenate([grid, text], 1)[:, None],
                           (3, 2, 16)).astype(np.int32)
    positions = pos3[0]
    want = jax_tf.forward(jcfg, w, jnp.asarray(toks), embeds=jnp.asarray(emb),
                          positions=jnp.asarray(positions),
                          mrope_positions=jnp.asarray(pos3))
    got = transformer.forward(tcfg, params, torch.from_numpy(toks).long(),
                              embeds=torch.from_numpy(emb),
                              positions=torch.from_numpy(positions).long(),
                              mrope_positions=torch.from_numpy(pos3).long())
    _close(got, want)
    # api.forward / api.prefill pass the prefix through; embeds alone
    # replace the tokens
    batch = {"tokens": torch.from_numpy(toks).long(), "embeds": torch.from_numpy(emb)}
    jbatch = {"tokens": jnp.asarray(toks), "embeds": jnp.asarray(emb)}
    _close(api.forward(tcfg, params, batch), jax_api.forward(jcfg, w, jbatch))
    lt, ct = api.prefill(tcfg, params, batch, 32)
    lj, cj = jax_api.prefill(jcfg, w, jbatch, 32)
    _close(lt, lj)
    _close(ct["segments"][0]["k"], cj["segments"][0]["k"])
    assert int(ct["index"]) == 16
    _close(api.forward(tcfg, params, {"embeds": torch.from_numpy(emb)}),
           jax_api.forward(jcfg, w, {"embeds": jnp.asarray(emb)}))


def test_qwen2_vl_prefill_decode_match_jax():
    jcfg, tcfg = _cfgs("qwen2-vl-2b")
    w = _weights(jcfg)
    params = bridge.tree_to_torch(w)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, size=(2, 21)).astype(np.int32)
    lj, cj = _jax_prefill(jcfg, w, jnp.asarray(toks), 40)
    lt, ct = transformer.prefill(tcfg, params, torch.from_numpy(toks).long(), 40)
    _close(lt, lj)
    nxt = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(5):
        lj, cj = _jax_decode(jcfg, w, jnp.asarray(nxt), cj)
        lt, ct = transformer.decode_step(tcfg, params, torch.from_numpy(nxt).long(), ct)
        _close(lt, lj)
        nxt = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)


@pytest.mark.parametrize("route,kv_quant", [("gather", False), ("pool", False),
                                             ("pool", True)],
                         ids=["gather", "pool", "pool-int8"])
def test_qwen2_vl_engine_matches_jax(route, kv_quant):
    """Paged serving with slot churn (5 prompts, 3 slots, 2 decoding at a
    time, pages of 4): the port's gather route, its pool route (decode
    from the pages through `paged_decode_attention`) and the int8 pool
    route, each against the JAX paged engine (gather route; int8 pool
    for the int8 case)."""
    jcfg, tcfg = _cfgs("qwen2-vl-2b")
    tcfg = tcfg.replace(**POOL) if route == "pool" else tcfg
    kw = dict(max_batch=3, max_len=48, decode_batch=2, page_size=4, kv_quant=kv_quant)
    teng = _serve_both(jcfg, tcfg, _weights(jcfg),
                       _prompts(jcfg.vocab, (5, 19, 9, 27, 13)), 9, **kw)
    assert teng.paged and teng.kv_quant_mode == ("paged" if kv_quant else "")


def test_qwen2_vl_decode_window_matches_jax():
    """The spec-decode verify (`decode_window`) with M-RoPE: a 4-token
    window after a 9-token prefill, logits and the written cache."""
    jcfg, tcfg = _cfgs("qwen2-vl-2b")
    w = _weights(jcfg)
    params = bridge.tree_to_torch(w)
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, jcfg.vocab, size=(2, 9)).astype(np.int32)
    win = rng.integers(0, jcfg.vocab, size=(2, 4)).astype(np.int32)
    _, jc = jax_api.prefill(jcfg, w, {"tokens": jnp.asarray(prompt)}, 16)
    _, tc = api.prefill(tcfg, params, {"tokens": torch.from_numpy(prompt).long()}, 16)
    lj, jc = jax_api.decode_window(jcfg, w, jnp.asarray(win), jc)
    lt, tc = api.decode_window(tcfg, params, torch.from_numpy(win).long(), tc)
    _close(lt, lj)
    _close(tc["segments"][0]["k"], jc["segments"][0]["k"])
    assert int(tc["index"]) == int(jc["index"]) == 13


@pytest.mark.parametrize("arch", NEW_ARCHS[:3])
def test_serve_cli_runs_new_transformer_archs_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main as serve_main
    serve_main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "12 tokens" in out and "3 prefills" in out and "on cpu" in out
