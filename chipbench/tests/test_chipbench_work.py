"""The frozen work counts against hand counts at small shapes."""
import pytest

from harness import work


def test_fused_mlp_by_hand():
    flops, nbytes = work.fused_mlp(4, 8, 16, 2)
    assert flops == 3 * 2 * 4 * 8 * 16
    assert nbytes == 2 * (3 * 8 * 16 + 4 * 8 + 4 * 8)


def test_moe_mlp_counts_only_rows_and_experts_in_use():
    flops, nbytes = work.moe_mlp([3, 0, 1, 0], 8, 16, 2)
    assert flops == 3 * 2 * 4 * 8 * 16
    assert nbytes == 2 * (2 * 3 * 8 * 16 + 2 * 4 * 8)
    assert work.moe_mlp([0, 0], 8, 16, 2) == (0.0, 0.0)


def test_roofline_takes_the_larger_bound():
    assert work.roofline_s(989e12, 1.0) == pytest.approx(1.0)
    assert work.roofline_s(1.0, 3.35e12) == pytest.approx(1.0)


GQA = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1,
       "intermediate_size": 12, "num_hidden_layers": 2, "vocab_size": 10, "sliding_window": 3}
MLA = {"hidden_size": 8, "num_attention_heads": 2, "q_lora_rank": 4, "kv_lora_rank": 3,
       "qk_nope_head_dim": 5, "qk_rope_head_dim": 2, "v_head_dim": 5, "intermediate_size": 12,
       "num_hidden_layers": 3, "first_k_dense_replace": 1, "n_routed_experts": 4,
       "num_experts_per_tok": 2, "moe_intermediate_size": 6, "n_shared_experts": 1,
       "vocab_size": 10}


def test_matmul_params_by_hand():
    attn = 8 * 8 + 2 * 8 * 4 + 8 * 8
    assert work.matmul_params(GQA) == 2 * (attn + 3 * 8 * 12) + 8 * 10
    mla = 8 * 4 + 4 * 2 * 7 + 8 * 5 + 3 * 2 * 10 + 2 * 5 * 8
    moe = 8 * 4 + 3 * 3 * 8 * 6
    assert work.matmul_params(MLA) == 3 * mla + 3 * 8 * 12 + 2 * moe + 8 * 10


def test_model_flops_by_hand():
    per_key = 2 * 2 * (4 + 4) * 2
    keys = (1 + 2 + 3) + 3 * 2       # a 5-token prefill, window 3: 1, 2, 3, 3, 3
    keys += 3 + 2                    # decode reads at positions 9 (window) and 1
    want = 2 * work.matmul_params(GQA) * (5 + 2) + per_key * keys
    assert work.model_flops(GQA, [5], [9, 1]) == want
    assert work.attention_flops_per_key(MLA) == 2 * 2 * (7 + 5) * 3
