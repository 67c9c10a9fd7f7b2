"""Greedy LM serving steps on the card: the counterparts of the prefill and
decode steps of ``repro.launch.steps.build_cell`` for the dense and MoE
families.

Each step returns greedy token ids, not logits, so its output stays small
on a 128k-256k vocabulary, and runs under ``torch.inference_mode``.  The
weights are cast once to the serving dtype (bf16, as ``build_cell``'s
``serve_dtype`` holds them), which is what halves the per-token weight
read.  ``use_pallas`` (the JAX flag's name) runs every layer's MLP through
the fused gated feed-forward kernel (``kernels.ops.fused_swiglu``), and
in the MoE family the shared experts' (the routed experts are einsums
over stacked weights, as in JAX): the port's serving path does by
default.  The JAX TPU steps leave the MLP to
XLA; ``use_pallas=False`` is that path, plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.core.chgnet import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import LMConfig


def load_serving_params(tree, cfg: LMConfig, device=None, *,
                        serve_dtype: str = "bfloat16"):
    """The parameter tree on ``device`` (``None``: the card; raises without
    CUDA) with every float leaf cast to ``serve_dtype``, once.  The steps
    need it equal to ``cfg.compute_dtype`` (bf16 for every full config;
    the SMOKE configs compute in f32)."""
    transformer.require_ported(cfg)
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
    """Prompt tokens (B, S) and positions (B, S) -> (next token (B,), bf16
    KV cache of ``max_len`` positions with S filled)."""
    logits, cache = transformer.prefill(cfg, params, tokens, positions,
                                        max_len, use_pallas=use_pallas)
    return torch.argmax(logits[..., -1, :], dim=-1), cache


@torch.inference_mode()
def decode_step(cfg: LMConfig, params, tokens, cache, positions, *,
                use_pallas: bool = True):
    """Tokens (B, 1) at positions (B, 1) -> (next token (B, 1), cache with
    one more position; its k / v are updated in place)."""
    logits, cache = transformer.decode_step(cfg, params, tokens, cache,
                                            positions, use_pallas=use_pallas)
    return torch.argmax(logits, dim=-1), cache
