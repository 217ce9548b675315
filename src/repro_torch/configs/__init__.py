"""Architecture registry of the port (the counterpart of
``repro.configs``).

``get_config(arch_id, smoke)`` returns the same ``ModelConfig`` as the JAX
package for the architectures the port runs so far: ``qwen2.5-3b``,
``recurrentgemma-2b`` and ``smollm-360m`` (attention, local attention and
RG-LRU layers with dense SwiGLU MLPs) and ``mamba2-2.7b`` (Mamba-2 SSD
layers, no MLP).  Every other id the JAX package
knows raises ``NotImplementedError`` naming the ROADMAP item that brings
it; an id neither package knows raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = (
    "qwen2.5-3b",
    "smollm-360m",
    "qwen3-32b",
    "recurrentgemma-2b",
    "pixtral-12b",
    "seamless-m4t-medium",
    "gemma3-27b",
    "llama4-maverick-400b-a17b",
    "qwen2-moe-a2.7b",
    "mamba2-2.7b",
    "bmoe-paper",
)

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "smollm-360m": "smollm_360m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-2.7b": "mamba2_2_7b",
}

# arch id -> the ROADMAP queue-A item that ports it
_NOT_PORTED = {
    "qwen2-moe-a2.7b": "A4.2 (LM MoE layers)",
    "llama4-maverick-400b-a17b": "A4.2 (LM MoE layers)",
    "bmoe-paper": "A4.2 (LM MoE layers)",
    "seamless-m4t-medium": "A4.3 (encoder-decoder)",
    "qwen3-32b": "A4.5 (remaining attention configs)",
    "gemma3-27b": "A4.5 (remaining attention configs)",
    "pixtral-12b": "A4.5 (remaining attention configs)",
}


def get_config(arch_id: str, smoke: bool = False):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: ROADMAP {_NOT_PORTED[arch_id]}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    if smoke and (cfg.train_microbatches != 1 or cfg.padded_num_experts):
        cfg = dataclasses.replace(cfg, train_microbatches=1,
                                  padded_num_experts=0)
    return cfg.validate()
