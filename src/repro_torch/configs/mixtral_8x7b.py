"""mixtral-8x7b [arXiv:2401.04088; hf] — 8-expert top-2 MoE with SWA.
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="transformer",
        n_layers=32, d_model=4096, n_heads=32, kv_heads=8, head_dim=128,
        d_ff=14336, vocab=32000, swiglu=True, window=4096,
        n_experts=8, top_k=2, rope_theta=1000000.0)
