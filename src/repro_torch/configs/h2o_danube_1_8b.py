"""h2o-danube-1.8b [arXiv:2401.16818; hf] — llama+mistral mix with
sliding-window attention. 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="transformer",
        n_layers=24, d_model=2560, n_heads=32, kv_heads=8, head_dim=80,
        d_ff=6912, vocab=32000, swiglu=True, window=4096,
        rope_theta=10000.0)
