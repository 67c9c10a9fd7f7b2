"""Per-family API of the port's LM substrate.

``family_fns(cfg)`` returns the family's bundle: init, the training loss,
logits over a sequence, prefill and decode.  The JAX ``FamilyFns`` also
carries sharding specs for the TPU mesh; those have no counterpart here.
The dense and MoE families are ported; every other family raises
(ROADMAP item 14d).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from . import transformer
from .config import LMConfig


@dataclasses.dataclass(frozen=True)
class FamilyFns:
    init: Callable              # (cfg, seed, *, device, dtype) -> params
    loss: Callable              # (cfg, params, tokens, labels, positions)
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
    transformer.require_ported(cfg)
    return FamilyFns(
        init=transformer.decoder_init,
        loss=transformer.lm_loss,
        forward=transformer.forward_train,
        prefill=transformer.prefill,
        decode_step=transformer.decode_step,
        init_decode_state=transformer.init_cache,
        has_positions=True,
        positions_3d=False,
        token_input=True,
        supports_long_context=False,
    )
