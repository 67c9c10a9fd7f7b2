"""Model configurations of the port.

``chgnet_mptrj`` holds the CHGNet family.  The LM architectures resolve
by id as in ``repro.configs``: each module exposes ``CONFIG`` (the exact
assigned configuration) and ``SMOKE`` (a reduced same-family config for
CPU tests).  The port has the dense decoders and the MoE family; the
other ids of the JAX registry (encoder-decoder, VLM, hybrid, RWKV) raise
``NotImplementedError`` (ROADMAP item 14d).
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
}

ARCH_IDS = ["llama3-8b", "gemma-2b", "qwen3-8b", "qwen1.5-110b",
            "phi3.5-moe-42b-a6.6b", "deepseek-moe-16b", "whisper-medium",
            "qwen2-vl-2b", "zamba2-1.2b", "rwkv6-3b"]


def _module(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP item 14d); the port "
            f"has {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> LMConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> LMConfig:
    return _module(name).SMOKE
