"""Architecture registry of the port: the plain-GQA dense transformers,
the sliding-window MoE transformer mixtral-8x7b and the two recurrent
families (RWKV6, RG-LRU hybrid) it serves.  Resolves `--arch <id>` like
`repro.configs`."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, smoke_config

_MODULES = {
    "smollm-135m": ".smollm_135m",
    "internlm2-1.8b": ".internlm2_1_8b",
    "qwen2.5-32b": ".qwen2_5_32b",
    "mixtral-8x7b": ".mixtral_8x7b",
    "rwkv6-3b": ".rwkv6_3b",
    "recurrentgemma-2b": ".recurrentgemma_2b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    cfg = importlib.import_module(_MODULES[arch], __name__).config()
    cfg.validate()
    return cfg


def get_smoke_config(arch: str) -> ModelConfig:
    return smoke_config(get_config(arch))
