"""rwkv6-3b "Finch" [arXiv:2404.05892; hf] — attention-free with
data-dependent decay.  32L d_model=2560 d_ff=8960 vocab=65536,
head_dim=64 (40 heads)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="rwkv6",
        n_layers=32, d_model=2560, n_heads=40, kv_heads=40, head_dim=64,
        d_ff=8960, vocab=65536, wkv_chunk=32)
