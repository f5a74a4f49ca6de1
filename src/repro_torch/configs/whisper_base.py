"""whisper-base [arXiv:2212.04356] — encoder-decoder audio backbone; the
conv frame frontend is a stub (callers pass frame embeddings).
6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865, LayerNorm+GELU."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="whisper",
        n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, kv_heads=8,
        head_dim=64, d_ff=2048, vocab=51865, norm="layernorm",
        swiglu=False, frontend="audio", dec_seq_factor=4)
