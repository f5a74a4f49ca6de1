"""Model configuration: the port's copy of `repro.models.config`.

Field for field the same frozen dataclass, so a config built on either
side compares equal field by field; only the dtype map differs (torch
dtypes in place of `jnp`'s).
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "transformer"       # transformer | rglru | rwkv6 | whisper
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    kv_heads: int = 2
    d_ff: int = 256
    vocab: int = 256
    head_dim: int | None = None
    qkv_bias: bool = False
    swiglu: bool = True
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    rope_theta: float = 10000.0
    window: int | None = None         # sliding-window attention
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    moe_d_ff: int | None = None
    capacity_factor: float = 1.25

    # MLA
    mla_q_rank: int = 0
    mla_kv_rank: int = 0
    mla_rope_dim: int = 64
    mtp: bool = False

    # M-RoPE
    mrope_sections: tuple[int, int, int] | None = None

    # RG-LRU hybrid
    attn_every: int = 0
    lru_width: int | None = None
    conv_width: int = 4

    # RWKV6
    wkv_chunk: int = 32
    wkv_lora: int = 32

    # Whisper enc-dec
    n_enc_layers: int = 0
    dec_seq_factor: int = 4

    # Modality frontend stub
    frontend: str = "none"
    vision_prefix_factor: int = 4

    # Performance variants of the JAX package (not read by the port)
    gqa_einsum: bool = False
    shard_hints: bool = False
    fused_ce: bool = False
    moe_groups: int = 0
    moe_shard_map: bool = False
    cache_seq_shard: bool = False

    # Numerics / execution
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    remat: str = "none"
    attn_impl: str = "auto"           # auto | einsum | chunked | local | flash
    mlp_impl: str = "dense"           # dense | fused (CUDA fused gated-MLP)
    norm_impl: str = "ref"            # ref | fused (CUDA RMSNorm(+residual))
    attn_chunk: int = 1024
    scan_layers: bool = True
    scan_min_layers: int = 8

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.hd

    @property
    def use_mla(self) -> bool:
        return self.mla_kv_rank > 0

    @property
    def use_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def tdtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def tparam_dtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def routed_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.family not in ("transformer", "rglru", "rwkv6", "whisper"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.mlp_impl not in ("dense", "fused"):
            raise ValueError(f"unknown mlp_impl {self.mlp_impl!r}")
        if self.norm_impl not in ("ref", "fused"):
            raise ValueError(f"unknown norm_impl {self.norm_impl!r}")
        if self.family == "transformer" and \
                self.n_heads % max(self.kv_heads, 1):
            raise ValueError("n_heads must be a multiple of kv_heads")
        if self.use_moe and not 0 < self.top_k <= self.n_experts:
            raise ValueError(f"top_k must lie in (0, n_experts={self.n_experts}], "
                             f"got {self.top_k}")
        if self.family == "rglru" and self.attn_every < 2:
            raise ValueError(f"rglru needs attn_every >= 2, got {self.attn_every}")
        if self.family == "whisper" and self.n_enc_layers <= 0:
            raise ValueError(f"whisper needs n_enc_layers > 0, got {self.n_enc_layers}")


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests: the same reduction as
    `repro.models.config.smoke_config` for the dense transformers."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "rglru" else 6),
        d_model=128,
        n_heads=4,
        kv_heads=max(1, min(cfg.kv_heads, 2)),
        head_dim=32,
        d_ff=256,
        vocab=512,
        dtype="float32", param_dtype="float32",
        scan_layers=cfg.scan_layers,
        scan_min_layers=2,
        attn_chunk=64,
    )
    if cfg.use_moe:
        kw.update(n_experts=4, top_k=2,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_dense_layers=min(cfg.first_dense_layers, 1),
                  moe_d_ff=64 if cfg.moe_d_ff else None)
    if cfg.use_mla:
        kw.update(mla_q_rank=64, mla_kv_rank=32, mla_rope_dim=16)
    if cfg.window:
        kw.update(window=64)
    if cfg.family == "rglru":
        kw.update(lru_width=128, attn_every=cfg.attn_every)
    if cfg.family == "whisper":
        kw.update(n_enc_layers=2, n_layers=2)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(4, 6, 6))
    return cfg.replace(**kw)
