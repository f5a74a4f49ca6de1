"""The program's model config of each configuration file follows its
published keys; the harness's weight tree has the serving engine's names
and shapes; the draw is fixed by the seed."""
import json

import pytest
import torch

from harness import weights
from harness.bench import HERE
from harness.runner import family, layout
from repro_torch.bridge import tree_paths
from repro_torch.models import api
from repro_torch.models.config import ModelConfig

import tiny

CONFIGS = sorted(p.name for p in (HERE / "configs").iterdir() if p.is_dir())


def _shapes(tree) -> dict:
    return {p: tuple(t.shape) for p, t in tree_paths(tree)}


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("size", ["tiny", "full"])
def test_tree_matches_the_engine(name, size):
    cfg = tiny.config(name) if size == "tiny" else \
        json.loads((HERE / "configs" / name / "config.json").read_text())
    mc = family(cfg).model_config(cfg)
    want = _shapes(api.param_shapes(mc))
    assert {path: shape for path, shape, _ in layout(cfg, mc)} == want


# a latent-attention model with routed and shared experts, for the
# layout's MLA and MoE leaves (no configuration file uses them yet)
MLA_MOE = dict(name="mla-moe", n_layers=3, d_model=64, n_heads=4, kv_heads=4, head_dim=16,
               d_ff=96, vocab=512, mla_q_rank=32, mla_kv_rank=16, mla_rope_dim=8,
               n_experts=8, top_k=2, n_shared_experts=1, first_dense_layers=1, moe_d_ff=32,
               dtype="float32", param_dtype="float32")


def test_mla_moe_tree_matches_the_engine():
    mc = ModelConfig(**MLA_MOE)
    mc.validate()
    want = _shapes(api.param_shapes(mc))
    assert {path: shape for path, shape, _ in family({"layout": "transformer"}).leaves(mc)} == want


@pytest.mark.parametrize("name", CONFIGS)
def test_model_config_follows_the_published_keys(name):
    cfg = json.loads((HERE / "configs" / name / "config.json").read_text())
    mc = family(cfg).model_config(cfg)
    assert (mc.n_layers, mc.d_model, mc.n_heads, mc.kv_heads, mc.d_ff, mc.vocab) == (
        cfg["num_hidden_layers"], cfg["hidden_size"], cfg["num_attention_heads"],
        cfg["num_key_value_heads"], cfg["intermediate_size"], cfg["vocab_size"])
    assert (mc.window, mc.rope_theta, mc.norm_eps, mc.tie_embeddings, mc.dtype) == (
        cfg.get("sliding_window"), cfg["rope_theta"], cfg["rms_norm_eps"],
        cfg["tie_word_embeddings"], cfg["torch_dtype"])
    assert mc.head_dim * mc.n_heads == mc.d_model and mc.swiglu and not mc.qkv_bias
    for bad in ({"hidden_act": "gelu"}, {"attention_bias": True}):
        with pytest.raises(ValueError):
            family(cfg).model_config(dict(cfg, **bad))


def test_draw_is_fixed_by_seed_and_aligned():
    cfg = tiny.config("h2o-danube-1.8b", "bfloat16")
    mc = family(cfg).model_config(cfg)
    lv = layout(cfg, mc)
    a = weights.draw(lv, 2**31 + 3, "cpu")
    b = weights.draw(lv, 2**31 + 3, "cpu")
    c = weights.draw(lv, 4, "cpu")
    pa, pb, pc = (dict(tree_paths(t)) for t in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa[("head",)], pc[("head",)])
    for k, t in pa.items():
        assert t.dtype == torch.bfloat16 and t.is_contiguous() and t.storage_offset() % 64 == 0
    emb = pa[("embed",)].float()
    assert 0.9 < float(emb.std()) < 1.1
