"""Model configurations of the port.

``chgnet_mptrj`` holds the CHGNet family.  The LM architectures resolve
by id as in ``repro.configs``: each module exposes ``CONFIG`` (the exact
assigned configuration) and ``SMOKE`` (a reduced same-family config for
CPU tests).  All ten ids of the JAX registry resolve: the dense decoders,
the MoE family, qwen2-vl (M-RoPE), zamba2 (hybrid), rwkv6 and whisper
(encoder-decoder).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import LMConfig

_MODULES = {
    "llama3-8b": "llama3_8b",
    "gemma-2b": "gemma_2b",
    "qwen3-8b": "qwen3_8b",
    "qwen1.5-110b": "qwen15_110b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-medium": "whisper_medium",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "zamba2-1.2b": "zamba2_1p2b",
    "rwkv6-3b": "rwkv6_3b",
}

ARCH_IDS = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> LMConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> LMConfig:
    return _module(name).SMOKE
