"""Per-family API of the port's LM substrate.

``family_fns(cfg)`` returns the family's bundle: init, the training loss,
logits over a sequence, prefill and decode, with one calling convention
across the five families (dense / MoE / VLM through
``models.transformer``, ``models.encdec``, ``models.hybrid``,
``models.rwkv``), mirroring ``repro.models.api``.  ``specs`` and
``decode_state_specs`` return the spec tuples of JAX's mesh layout (a
tuple with one entry a dimension), leaf by leaf as JAX's
``PartitionSpec`` trees: the port executes neither tensor parallelism
nor FSDP (its multi-rank layouts are DP replicas and GPipe stages), so
they are data, read by ``configs.shapes`` and ``launch.dryrun`` to state
each leaf's bytes a rank.  ``prefill`` is ``(cfg, params, inputs, positions, max_len, **kw)
-> (logits, state)`` for every family: rwkv ignores ``max_len`` (its
state is O(1)); whisper's is ``encode`` + ``init_cache``, and its logits
are the JAX serving step's placeholder readout (``repro.launch.steps.
build_cell``), whose greedy token is 0.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import encdec, hybrid, rwkv, transformer
from .config import LMConfig


@dataclasses.dataclass(frozen=True)
class FamilyFns:
    init: Callable              # (cfg, seed, *, device, dtype) -> params
    specs: Callable             # (cfg, mesh_sizes) -> spec tuples
    loss: Callable              # (cfg, params, inputs, labels, [positions])
    forward: Callable           # (cfg, params, inputs, positions) -> logits
    prefill: Callable           # (cfg, params, inputs, positions, max_len)
    decode_step: Callable       # (cfg, params, tokens, state, positions)
    init_decode_state: Callable  # (cfg, batch, max_len, dtype, device)
    decode_state_specs: Callable  # (cfg, mesh_sizes, batch_axes, seq_axis)
    has_positions: bool         # the forwards take positions
    positions_3d: bool          # M-RoPE (B, S, 3)
    token_input: bool           # False => float frames input (whisper)
    supports_long_context: bool


def _transformer_fns(cfg: LMConfig) -> FamilyFns:
    def state_specs(c, mesh_sizes, batch_axes, seq_axis):
        return transformer.cache_specs(c, mesh_sizes, batch_axes=batch_axes,
                                       seq_axis=seq_axis)

    return FamilyFns(
        init=transformer.decoder_init,
        specs=transformer.decoder_specs,
        loss=transformer.lm_loss,
        forward=transformer.forward_train,
        prefill=transformer.prefill,
        decode_step=transformer.decode_step,
        init_decode_state=transformer.init_cache,
        decode_state_specs=state_specs,
        has_positions=True,
        positions_3d=bool(cfg.mrope_sections),
        token_input=True,
        supports_long_context=False,
    )


def _encdec_fns(cfg: LMConfig) -> FamilyFns:
    def loss(c, params, frames, labels, positions=None, **fw):
        return encdec.lm_loss(c, params, frames, labels, **fw)

    def prefill(c, params, frames, positions, max_len, *, chunk=1024,
                cache_dtype=torch.bfloat16):
        enc_out = encdec.encode(c, params, frames, attn_mode="chunked",
                                chunk=chunk)
        cache = encdec.init_cache(c, params, enc_out, max_len, cache_dtype)
        return enc_out[:, -1:, :1], cache  # placeholder readout: token 0

    def decode(c, params, tokens, state, positions=None):
        return encdec.decode_step(c, params, tokens, state)

    def init_state(c, batch, max_len, dtype=torch.bfloat16, device=None):
        raise NotImplementedError(
            "the cache holds the encoder's cross K / V: use "
            "encdec.init_cache(cfg, params, enc_out, max_len) directly")

    def state_specs(c, mesh_sizes, batch_axes, seq_axis):
        return encdec.cache_specs(c, mesh_sizes, batch_axes=batch_axes,
                                  seq_axis=seq_axis)

    return FamilyFns(
        init=encdec.whisper_init,
        specs=encdec.whisper_specs,
        loss=loss,
        forward=encdec.forward_train,   # (cfg, params, frames, dec_tokens)
        prefill=prefill,
        decode_step=decode,
        init_decode_state=init_state,
        decode_state_specs=state_specs,
        has_positions=False,
        positions_3d=False,
        token_input=False,
        supports_long_context=False,
    )


def _hybrid_fns(cfg: LMConfig) -> FamilyFns:
    def state_specs(c, mesh_sizes, batch_axes, seq_axis):
        return hybrid.state_specs(c, mesh_sizes, batch_axes=batch_axes,
                                  seq_axis=seq_axis)

    return FamilyFns(
        init=hybrid.zamba_init,
        specs=hybrid.zamba_specs,
        loss=hybrid.lm_loss,
        forward=hybrid.forward_train,
        prefill=hybrid.prefill,
        decode_step=hybrid.decode_step,
        init_decode_state=hybrid.init_state,
        decode_state_specs=state_specs,
        has_positions=True,
        positions_3d=False,
        token_input=True,
        supports_long_context=True,
    )


def _rwkv_fns(cfg: LMConfig) -> FamilyFns:
    def prefill(c, params, tokens, positions=None, max_len=None):
        del max_len  # O(1) state, independent of context length
        return rwkv.prefill(c, params, tokens)

    def init_state(c, batch, max_len, dtype=torch.bfloat16, device=None):
        del max_len
        return rwkv.rwkv_init_states(c, batch, dtype, device)

    def state_specs(c, mesh_sizes, batch_axes, seq_axis):
        del mesh_sizes, seq_axis
        return rwkv.state_specs(c, batch_axes)

    return FamilyFns(
        init=rwkv.rwkv_init,
        specs=rwkv.rwkv_specs,
        loss=rwkv.lm_loss,
        forward=rwkv.forward_train,
        prefill=prefill,
        decode_step=rwkv.decode_step,
        init_decode_state=init_state,
        decode_state_specs=state_specs,
        has_positions=False,
        positions_3d=False,
        token_input=True,
        supports_long_context=True,
    )


def family_fns(cfg: LMConfig) -> FamilyFns:
    if cfg.family in ("dense", "moe", "vlm"):
        return _transformer_fns(cfg)
    if cfg.family == "encdec":
        return _encdec_fns(cfg)
    if cfg.family == "hybrid":
        return _hybrid_fns(cfg)
    if cfg.family == "rwkv":
        return _rwkv_fns(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
