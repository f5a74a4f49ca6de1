"""recurrentgemma-2b [arXiv:2402.19427; hf] — Griffin: RG-LRU recurrent
blocks + local attention in a 1:2 pattern.  26L d_model=2560 10H
(MQA kv=1) d_ff=7680 vocab=256000, lru_width=2560, window=2048."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="rglru",
        n_layers=26, d_model=2560, n_heads=10, kv_heads=1, head_dim=256,
        d_ff=7680, vocab=256000, lru_width=2560, attn_every=3,
        window=2048, conv_width=4)
