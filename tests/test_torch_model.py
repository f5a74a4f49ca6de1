"""Model parity of the PyTorch/CUDA port on the CPU: the weight bridge,
then `forward` and `decode_step` logits of the port against the JAX
package on the same transferred weights, for the smoke configs of the
ported archs, with the plain impls and with the kernel impls (flash /
fused / fused; the JAX side runs its Pallas kernels in interpret mode).
Float32, logits within atol/rtol 1e-4; greedy continuations equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as jax_tf
from repro_torch import bridge, configs
from repro_torch.models import api, transformer

ARCHS = ("smollm-135m", "internlm2-1.8b", "qwen2.5-32b")
KERNEL_IMPLS = dict(attn_impl="flash", mlp_impl="fused", norm_impl="fused")
TOL = dict(rtol=1e-4, atol=1e-4)

# module-level jits: ModelConfig is hashable, so it rides as a static arg
_jax_forward = jax.jit(jax_tf.forward, static_argnums=(0,))
_jax_prefill = jax.jit(jax_tf.prefill, static_argnums=(0, 3))
_jax_decode = jax.jit(jax_tf.decode_step, static_argnums=(0,))


def _cfgs(arch, impls):
    jcfg = jax_configs.get_smoke_config(arch).replace(**impls)
    tcfg = configs.get_smoke_config(arch).replace(**impls)
    return jcfg, tcfg


def _weights(jcfg, seed=0):
    """JAX init_params as a numpy tree; QKV biases (zero at init) get
    random values so the bias path is exercised."""
    tree = jax.tree.map(np.asarray, jax_tf.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    attn = tree["segments"][0]["kind_dense"]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = (0.1 * rng.standard_normal(attn[name].shape)).astype(np.float32)
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax_registry(arch):
    for get_j, get_t in ((jax_configs.get_config, configs.get_config),
                         (jax_configs.get_smoke_config, configs.get_smoke_config)):
        assert dataclasses.asdict(get_t(arch)) == dataclasses.asdict(get_j(arch))


def test_bridge_bf16_is_bit_exact():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)), jnp.bfloat16)
    tree = {"a": [np.asarray(x)], "b": np.arange(4, dtype=np.int32)}
    out = bridge.tree_to_torch(tree)
    assert out["a"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["a"][0].float().numpy(),
                                  np.asarray(x, np.float32))
    assert out["b"].dtype == torch.int32 and out["b"].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("impls", [{}, KERNEL_IMPLS], ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_jax(arch, impls):
    jcfg, tcfg = _cfgs(arch, impls)
    w = _weights(jcfg)
    params = bridge.tree_to_torch(w)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, size=(2, 12)).astype(np.int32)

    lj = _jax_forward(jcfg, w, jnp.asarray(toks))
    lt = api.forward(tcfg, params, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)

    # one decode step from the same (JAX-filled) cache, per-slot index
    _, cache_j = _jax_prefill(jcfg, w, jnp.asarray(toks), 32)
    cache_j = dict(cache_j, index=jnp.asarray([12, 9], jnp.int32))
    cache_t = bridge.tree_to_torch(jax.tree.map(np.asarray, cache_j))
    nxt = rng.integers(0, jcfg.vocab, size=(2, 1)).astype(np.int32)
    dj, _ = _jax_decode(jcfg, w, jnp.asarray(nxt), cache_j)
    dt, new = transformer.decode_step(tcfg, params, torch.from_numpy(nxt).long(),
                                      cache_t)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    assert new["index"].tolist() == [13, 10]


@pytest.mark.parametrize("impls", [{}, KERNEL_IMPLS], ids=["plain", "kernels"])
def test_greedy_continuation_matches_jax(impls):
    jcfg, tcfg = _cfgs("smollm-135m", impls)
    w = _weights(jcfg)
    params = bridge.tree_to_torch(w)
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab, (1, 9)).astype(np.int32)

    last, cache = _jax_prefill(jcfg, w, jnp.asarray(prompt), 32)
    out_j = [int(jnp.argmax(last[0, -1]))]
    for _ in range(7):
        lg, cache = _jax_decode(jcfg, w, jnp.asarray([[out_j[-1]]], jnp.int32), cache)
        out_j.append(int(jnp.argmax(lg[0, -1])))

    last, cache = api.prefill(tcfg, params,
                              {"tokens": torch.from_numpy(prompt).long()}, 32)
    out_t = [int(last[0, -1].argmax())]
    for _ in range(7):
        lg, cache = api.decode_step(tcfg, params, torch.tensor([[out_t[-1]]]),
                                    cache)
        out_t.append(int(lg[0, -1].argmax()))
    assert out_t == out_j


def test_init_params_shapes_match_jax_and_default_to_cuda():
    jcfg, tcfg = _cfgs("qwen2.5-32b", {})
    shapes_j = jax.tree.map(lambda a: tuple(a.shape),
                            jax.eval_shape(lambda: jax_tf.init_params(
                                jcfg, jax.random.PRNGKey(0))))
    p = api.init_params(tcfg, 0, device="cpu")
    shapes_t = jax.tree.map(lambda a: tuple(a.shape), p)
    assert shapes_t == shapes_j
    again = api.init_params(tcfg, 0, device="cpu")
    assert torch.equal(p["embed"], again["embed"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.init_params(tcfg, 0)


def test_unported_variants_raise():
    """Sliding windows, capacity MoE, MLA, M-RoPE, the MTP subtree and
    LayerNorm init (their trees are held against JAX in
    tests/test_torch_{mla,variants,whisper}.py); the transformer module
    still raises for another family."""
    cfg = configs.get_smoke_config("smollm-135m")
    moe = dict(n_experts=4, top_k=2)
    for kw in (dict(window=8), moe, dict(mla_q_rank=64, mla_kv_rank=32),
               dict(mrope_sections=(4, 6, 6)), dict(norm="layernorm"),
               dict(mla_q_rank=64, mla_kv_rank=32, mtp=True)):
        p = api.init_params(cfg.replace(**kw), 0, device="cpu")
        assert ("mtp" in p) == kw.get("mtp", False)
        if kw.get("norm") == "layernorm":
            assert set(p["final_norm"]) == {"scale", "bias"}
    with pytest.raises(NotImplementedError):
        transformer.init_params(cfg.replace(family="rwkv6"), torch.Generator())


@pytest.mark.parametrize("dispatch", [dict(moe_groups=2), dict(moe_shard_map=True)],
                         ids=["groups", "shard_map"])
def test_moe_dispatch_variants_init(dispatch):
    """The grouped and shard_map MoE dispatch variants init (their outputs
    are held against JAX in tests/test_torch_moe_dispatch.py)."""
    cfg = configs.get_smoke_config("smollm-135m").replace(n_experts=4, top_k=2, **dispatch)
    p = api.init_params(cfg, 0, device="cpu")
    assert "moe" in p["segments"][0]["kind_moe"]
