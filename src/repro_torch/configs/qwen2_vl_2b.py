"""qwen2-vl-2b [arXiv:2409.12191; hf] — VLM text backbone with M-RoPE;
the dynamic-resolution vision frontend is a stub (callers pass patch
embeddings as `embeds`).  28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="transformer",
        n_layers=28, d_model=1536, n_heads=12, kv_heads=2, head_dim=128,
        d_ff=8960, vocab=151936, swiglu=True, qkv_bias=True,
        mrope_sections=(16, 24, 24), frontend="vision",
        rope_theta=1000000.0)
