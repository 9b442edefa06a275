"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``.

A copy of the JAX package's ``configs/`` (pure dataclasses, no JAX), so
the port imports nothing from it.  Every architecture is a selectable
config (``--arch <id>`` in the launchers); each module cites its source
paper or model card.  The port's LM server runs the ``attn`` and ``ssm``
mixers with dense or no FFN (``qwen2-7b``, ``mamba2-2.7b`` and the other
dense archs); MoE, MLA and the encoder-decoder raise.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (MLAConfig, ModelConfig, ShapeConfig,
                                SSMConfig, SHAPES, TRAIN_4K, PREFILL_32K,
                                DECODE_32K, LONG_500K)

_ARCH_MODULES = {
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
}


def list_archs():
    return sorted(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["ModelConfig", "ShapeConfig", "MLAConfig", "SSMConfig",
           "get_config", "get_shape", "list_archs", "SHAPES",
           "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"]
