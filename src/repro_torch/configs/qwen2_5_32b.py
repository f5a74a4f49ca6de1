"""qwen2.5-32b [hf:Qwen/Qwen2.5 family] — GQA with QKV bias.
64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="transformer",
        n_layers=64, d_model=5120, n_heads=40, kv_heads=8, head_dim=128,
        d_ff=27648, vocab=152064, swiglu=True, qkv_bias=True,
        rope_theta=1000000.0)
