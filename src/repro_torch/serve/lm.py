"""Greedy LM serving steps on the card: the counterparts of the prefill and
decode steps of ``repro.launch.steps.build_cell``, for every family
(dispatched through ``models.api.family_fns``, as ``build_cell``
dispatches): dense, MoE and VLM decoders, the zamba2 hybrid, rwkv6 and
whisper (its prefill is ``encode`` + ``init_cache``; its next token is
JAX's placeholder readout, token 0, from which decoding starts).

Each step returns greedy token ids, not logits, so its output stays small
on a 128k-256k vocabulary, and runs under ``torch.inference_mode``.  The
weights are cast once to the serving dtype (bf16, as ``build_cell``'s
``serve_dtype`` holds them), which is what halves the per-token weight
read.  ``use_pallas`` (the JAX flag's name) runs every gated MLP
through the fused feed-forward kernel (``kernels.ops.fused_swiglu``):
every layer's in the dense and VLM families, the shared experts' in the
MoE family (the routed experts are einsums over stacked weights, as in
JAX), the shared block's in the hybrid; the port's serving path does by
default.  rwkv6 and whisper have no gated MLP and run on no kernel.  The
JAX TPU steps leave the MLP to XLA; ``use_pallas=False`` is that path,
plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.core.chgnet import resolve_device
from repro_torch.models.api import family_fns
from repro_torch.models.config import LMConfig

# the families with a gated MLP, whose forwards take ``use_pallas``
GATED_FAMILIES = ("dense", "moe", "vlm", "hybrid")


def kernel_kw(cfg: LMConfig, use_pallas: bool) -> dict:
    """``use_pallas`` for the family's forwards, where it has a gated MLP
    (rwkv6 and whisper run on no kernel)."""
    return {"use_pallas": use_pallas} if cfg.family in GATED_FAMILIES \
        else {}


def load_serving_params(tree, cfg: LMConfig, device=None, *,
                        serve_dtype: str = "bfloat16"):
    """The parameter tree on ``device`` (``None``: the card; raises without
    CUDA) with every float leaf cast to ``serve_dtype``, once.  The steps
    need it equal to ``cfg.compute_dtype`` (bf16 for every full config;
    the SMOKE configs compute in f32)."""
    family_fns(cfg)  # an unknown family raises
    dev = resolve_device(device)
    dtype = getattr(torch, serve_dtype)

    def load(t):
        if isinstance(t, dict):
            return {k: load(v) for k, v in t.items()}
        return t.to(device=dev, dtype=dtype if t.is_floating_point()
                    else t.dtype)

    return load(tree)


@torch.inference_mode()
def prefill_step(cfg: LMConfig, params, tokens, positions, max_len: int, *,
                 use_pallas: bool = True):
    """Prompt tokens (B, S) (whisper: frames (B, S_enc, d)) and positions
    ((B, S), (B, S, 3) for M-RoPE, ``None`` for rwkv and whisper) ->
    (next token (B,), decode state: a bf16 KV cache of ``max_len``
    positions with S filled, and the recurrent states)."""
    logits, state = family_fns(cfg).prefill(
        cfg, params, tokens, positions, max_len,
        **kernel_kw(cfg, use_pallas))
    return torch.argmax(logits[..., -1, :], dim=-1), state


@torch.inference_mode()
def decode_step(cfg: LMConfig, params, tokens, cache, positions, *,
                use_pallas: bool = True):
    """Tokens (B, 1) at positions (B, 1) (or (B, 1, 3); ``None`` for rwkv
    and whisper) -> (next token (B, 1), state with one more position; KV
    caches are updated in place)."""
    logits, cache = family_fns(cfg).decode_step(
        cfg, params, tokens, cache, positions,
        **kernel_kw(cfg, use_pallas))
    return torch.argmax(logits, dim=-1), cache
