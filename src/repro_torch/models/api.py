"""Per-family API of the port's LM substrate.

``family_fns(cfg)`` returns the forward-only bundle of the family: init,
logits over a sequence, prefill and decode.  The JAX ``FamilyFns`` also
carries the training loss and sharding specs; those come with LM training
and multi-GPU (ROADMAP items 14 and 13).  The dense family is ported;
every other family raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from . import transformer
from .config import LMConfig


@dataclasses.dataclass(frozen=True)
class FamilyFns:
    init: Callable              # (cfg, seed, *, device, dtype) -> params
    forward: Callable           # (cfg, params, tokens, positions) -> logits
    prefill: Callable           # (cfg, params, tokens, positions, max_len)
    decode_step: Callable       # (cfg, params, tokens, cache, positions)
    init_decode_state: Callable  # (cfg, batch, max_len, dtype, device)
    has_positions: bool         # the forwards take positions
    positions_3d: bool          # M-RoPE (B, S, 3)
    token_input: bool           # False => float frames input (whisper)
    supports_long_context: bool


def family_fns(cfg: LMConfig) -> FamilyFns:
    if cfg.family not in ("dense", "moe", "vlm", "encdec", "hybrid",
                          "rwkv"):
        raise ValueError(f"unknown family {cfg.family!r}")
    transformer.require_dense(cfg)
    return FamilyFns(
        init=transformer.decoder_init,
        forward=transformer.forward_train,
        prefill=transformer.prefill,
        decode_step=transformer.decode_step,
        init_decode_state=transformer.init_cache,
        has_positions=True,
        positions_3d=False,
        token_input=True,
        supports_long_context=False,
    )
