"""DeepSeek-V3's MLA (multi-head latent attention) in the PyTorch/CUDA port
on the CPU against the JAX package, float32, on the same transferred
weights (logits within 1e-4, greedy tokens equal), with deepseek-v3-671b's
smoke config (MLA, one dense layer before capacity-routed MoE layers with
a shared expert, MTP):

* the init tree, the `mtp` subtree included, leaf for leaf;
* forward, prefill (the latent cache) and the absorbed one-token decode;
* the latent caches' shapes, dense and paged, and a paged MLA engine
  (a dense-MLP variant: MoE is never paged) on the gather route;
* the engine's tokens over dense latent KV with capacity MoE (the port's
  `moe_mlp` plain version) and with `kv_quant="dense"` over the latents;
* MLA with `attn_impl="flash"` refused by both packages' flash op.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core.policy import ExecutionPolicy as JaxPolicy
from repro.core.policy import OperatorPolicy as JaxOperatorPolicy
from repro.launch.serve import apply_policy as jax_apply_policy
from repro.models import api as jax_api
from repro.models import transformer as jax_tf
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.launch.policy import load_policy
from repro_torch.launch.serve import apply_policy, serve
from repro_torch.models import api, transformer
from repro_torch.serving import quant
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=1e-4, atol=1e-4)

_jax_forward = jax.jit(jax_tf.forward, static_argnums=(0,))
_jax_prefill = jax.jit(jax_tf.prefill, static_argnums=(0, 3))
_jax_decode = jax.jit(jax_tf.decode_step, static_argnums=(0,))


def _cfgs(**kw):
    return (jax_configs.get_smoke_config(ARCH).replace(**kw),
            configs.get_smoke_config(ARCH).replace(**kw))


@functools.lru_cache(maxsize=None)
def _weights(jcfg, seed=0):
    """JAX init_params as a numpy tree, drawn once a config (the bridge
    copies it, so no test writes into it)."""
    return jax.tree.map(np.asarray, jax.jit(jax_api.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed)))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _prompts(vocab, lens, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in lens]


def _serve_both(jcfg, tcfg, prompts, max_new, **kw):
    w = _weights(jcfg)
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
    for key in ("decode_steps", "prefills", "tokens_out", "rejected"):
        assert teng.stats[key] == jeng.stats[key], key
    return jeng, teng


def test_init_tree_matches_jax_with_mtp():
    jcfg, tcfg = _cfgs()
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: jax_api.init_params(jcfg, jax.random.PRNGKey(0))))
    p = api.init_params(tcfg, 0, device="cpu")
    assert bridge.tree_map(lambda t: tuple(t.shape), p) == shapes_j
    assert set(p["mtp"]) == {"proj", "norm", "layer"}
    assert set(p["segments"][0]["kind_dense"]["attn"]) == {
        "wdq", "q_norm", "wuq", "wdkv", "kv_norm", "wuk", "wuv", "wo"}


@pytest.mark.parametrize("plen", [9, 40])
def test_mla_forward_prefill_decode_match_jax(plen):
    jcfg, tcfg = _cfgs()
    w = _weights(jcfg)
    params = bridge.tree_to_torch(w)
    toks = np.random.default_rng(plen).integers(0, jcfg.vocab, size=(2, plen)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    _close(transformer.forward(tcfg, params, tt), _jax_forward(jcfg, w, jnp.asarray(toks)))
    lj, cj = _jax_prefill(jcfg, w, jnp.asarray(toks), 64)
    lt, ct = transformer.prefill(tcfg, params, tt, 64)
    _close(lt, lj)
    for sj, st in zip(cj["segments"], ct["segments"]):
        assert set(st) == {"latent"}
        _close(st["latent"], sj["latent"])
    nxt = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(6):
        lj, cj = _jax_decode(jcfg, w, jnp.asarray(nxt), cj)
        lt, ct = transformer.decode_step(tcfg, params, torch.from_numpy(nxt).long(), ct)
        _close(lt, lj)
        nxt = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for sj, st in zip(cj["segments"], ct["segments"]):
        _close(st["latent"], sj["latent"])


def test_latent_cache_shapes_match_jax():
    """Dense rectangles (L, B, C, kv_rank + rope_dim) a segment and the
    paged latent pool (L, P, ps, kv_rank + rope_dim); the int8 scales of
    a latent leaf drop its positions and its width, (L, B, 1, 1)."""
    jcfg, tcfg = _cfgs()
    dense_j = jax_tf.init_cache(jcfg, 3, 40)
    dense_t = transformer.init_cache(tcfg, 3, 40)
    assert bridge.tree_map(lambda t: tuple(t.shape), dense_t["segments"]) == \
        jax.tree.map(lambda a: tuple(a.shape), dense_j["segments"])
    pool_j = jax_tf.init_paged_cache(jcfg, 9, 4)
    pool_t = transformer.init_paged_cache(tcfg, 9, 4)
    assert bridge.tree_map(lambda t: tuple(t.shape), pool_t) == \
        jax.tree.map(lambda a: tuple(a.shape), pool_j)
    assert pool_t[0]["latent"].shape == (1, 9, 4, 32 + 16)
    assert [s["latent"].shape for s in quant.scale_struct(dense_t["segments"])] == \
        [(1, 3, 1, 1), (3, 3, 1, 1)]
    # one latent page: (L, 1, ps, D) codes and (L, 1, 1, 1) scales a segment
    assert quant.kv_page_nbytes(tcfg, 4, True) == 4 * (4 * 48 + 4)
    assert quant.kv_page_nbytes(tcfg, 4, False) == 4 * 4 * 48 * 4


def test_paged_mla_engine_matches_jax():
    """MLA without MoE serves paged: the bucketed prefill scatters latent
    pages, decode gathers them (MLA has no pool route) - against the JAX
    paged engine, with churn over three slots."""
    jcfg, tcfg = _cfgs(n_experts=0, top_k=0, n_shared_experts=0,
                       first_dense_layers=0, moe_d_ff=None)
    _, teng = _serve_both(jcfg, tcfg, _prompts(jcfg.vocab, (5, 18, 7, 23)), 7,
                          max_batch=3, max_len=40, decode_batch=2, page_size=4)
    assert teng.paged and set(teng.pool.segments[0]) == {"latent"}


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
def test_deepseek_engine_matches_jax(compact):
    """Dense latent KV (MoE is never paged), capacity MoE through the
    port's `moe_mlp` (its plain version on the CPU) against the JAX
    engine's einsums; slot churn over three slots."""
    jcfg, tcfg = _cfgs()
    _, teng = _serve_both(jcfg, tcfg.replace(mlp_impl="fused"),
                          _prompts(jcfg.vocab, (6, 25, 11, 30, 8)), 8,
                          max_batch=3, max_len=48, decode_batch=2, compact=compact)
    assert teng.state.kind == "dense" and set(teng.cache["segments"][0]) == {"latent"}


def test_deepseek_dense_int8_latents_match_jax():
    """`kv_quant="dense"` over the latent rectangles: the JAX
    `_dense_quant_step_fn`'s tokens, and codes and scales leaf by leaf
    (one rounding step of slack on the codes)."""
    jcfg, tcfg = _cfgs()
    jeng, teng = _serve_both(jcfg, tcfg, _prompts(jcfg.vocab, (6, 21, 13)), 7,
                             max_batch=2, max_len=40, kv_quant="dense")
    assert teng.kv_quant_mode == "dense"
    for sj, st, scj, sct in zip(jeng.state.cache["segments"], teng.cache["segments"],
                                jeng.state.scales, teng.state.scales):
        assert st["latent"].dtype == torch.int8
        assert sct["latent"].shape == np.asarray(scj["latent"]).shape
        np.testing.assert_allclose(sct["latent"].numpy(), np.asarray(scj["latent"]),
                                   rtol=1e-5, atol=0)
        diff = np.abs(st["latent"].numpy().astype(int) - np.asarray(sj["latent"]).astype(int))
        assert diff.max() <= 1


def test_mla_flash_policy_raises_at_prefill_in_both_packages(tmp_path):
    """A policy with the three fusion flags on sets attn_impl="flash" on
    deepseek in both launchers; the first prefill then raises in both
    engines: JAX's flash op reshapes v to q's width, the port's op
    refuses k and v of different shapes on either device."""
    ops = [JaxOperatorPolicy(group=g, batch=2, tp=1, memory="HBM3",
                             chiplet="WS-pe64-glb512K-2D", fused=True)
           for g in ("norm1+qkv_proj+attention", "norm2+mlp")]
    d = JaxPolicy(network="n", interval_s=1e-3, operators=ops).to_dict()
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(d))
    jcfg, jkw, _ = jax_apply_policy(JaxPolicy.from_dict(d),
                                    jax_configs.get_smoke_config(ARCH), 2, n_devices=1)
    tcfg, tkw, _ = apply_policy(load_policy(path), configs.get_smoke_config(ARCH), 2,
                                n_devices=1)
    assert jcfg.attn_impl == tcfg.attn_impl == "flash" and tkw == jkw
    w = _weights(_cfgs()[0])
    prompt = np.zeros(8, np.int32)
    jeng = JaxEngine(jcfg, w, max_batch=2, max_len=32)
    jeng.submit(JaxRequest(rid=0, prompt=prompt, max_new_tokens=2))
    with pytest.raises((TypeError, ValueError)):
        jeng.run()
    teng = ServingEngine(tcfg, bridge.tree_to_torch(w), max_batch=2, max_len=32,
                         device="cpu")
    teng.submit(Request(rid=0, prompt=prompt, max_new_tokens=2))
    with pytest.raises(ValueError, match="k and v"):
        teng.run()
