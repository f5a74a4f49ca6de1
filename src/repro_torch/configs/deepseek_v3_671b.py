"""deepseek-v3-671b [arXiv:2412.19437; hf] — MLA latent attention,
1 shared + 256 routed experts top-8, MTP.  61L d_model=7168 128H
d_ff=2048 vocab=129280."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="transformer",
        n_layers=61, d_model=7168, n_heads=128, kv_heads=128, head_dim=128,
        d_ff=2048, vocab=129280, swiglu=True,
        n_experts=256, top_k=8, n_shared_experts=1, first_dense_layers=3,
        moe_d_ff=2048, mla_q_rank=1536, mla_kv_rank=512, mla_rope_dim=64,
        mtp=True, rope_theta=10000.0)
