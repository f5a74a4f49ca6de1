"""internlm2-1.8b [arXiv:2403.17297; hf] — GQA dense transformer.
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", family="transformer",
        n_layers=24, d_model=2048, n_heads=16, kv_heads=8, head_dim=128,
        d_ff=8192, vocab=92544, swiglu=True, rope_theta=1000000.0)
