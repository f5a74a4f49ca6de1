"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small model.
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, tied embeddings."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="transformer",
        n_layers=30, d_model=576, n_heads=9, kv_heads=3, head_dim=64,
        d_ff=1536, vocab=49152, swiglu=True, tie_embeddings=True,
        rope_theta=10000.0)
