"""Architecture registry of the port (the counterpart of
``repro.configs``).

``get_config(arch_id, smoke)`` returns the same ``ModelConfig`` as the JAX
package for every architecture it declares: dense and GQA attention
(qwen2.5-3b, smollm-360m, qwen3-32b with qk_norm), local and global
attention (gemma3-27b 5:1, recurrentgemma-2b with RG-LRU layers), the
vision-prefix pixtral-12b, the encoder-decoder seamless-m4t-medium,
Mamba-2 (mamba2-2.7b) and the MoE models (qwen2-moe-a2.7b,
llama4-maverick-400b-a17b, bmoe-paper).  An unknown id raises
``KeyError``.
"""
from __future__ import annotations

import dataclasses
import importlib

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "smollm-360m": "smollm_360m",
    "qwen3-32b": "qwen3_32b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "pixtral-12b": "pixtral_12b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "gemma3-27b": "gemma3_27b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "bmoe-paper": "bmoe_paper",
}
ARCH_IDS = tuple(_MODULES)           # in the JAX package's order


def get_config(arch_id: str, smoke: bool = False):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    if smoke and (cfg.train_microbatches != 1 or cfg.padded_num_experts):
        cfg = dataclasses.replace(cfg, train_microbatches=1,
                                  padded_num_experts=0)
    return cfg.validate()
