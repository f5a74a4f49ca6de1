"""Architecture registry of the port: the ten archs of `repro.configs`
(dense and sliding-window GQA transformers, M-RoPE qwen2-vl, the MLA
MoE deepseek-v3, mixtral's sliding-window MoE, the RWKV6 and RG-LRU
recurrent families and the whisper encoder-decoder), in its order.
Resolves `--arch <id>` like `repro.configs`."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, smoke_config

_MODULES = {
    "h2o-danube-1.8b": ".h2o_danube_1_8b",
    "smollm-135m": ".smollm_135m",
    "internlm2-1.8b": ".internlm2_1_8b",
    "qwen2.5-32b": ".qwen2_5_32b",
    "mixtral-8x7b": ".mixtral_8x7b",
    "deepseek-v3-671b": ".deepseek_v3_671b",
    "qwen2-vl-2b": ".qwen2_vl_2b",
    "recurrentgemma-2b": ".recurrentgemma_2b",
    "whisper-base": ".whisper_base",
    "rwkv6-3b": ".rwkv6_3b",
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
