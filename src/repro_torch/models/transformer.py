"""Decoder-only transformer LM, dense, MoE and VLM families: logits over a
sequence, the next-token loss, prefill into a KV cache, one-token decode.

Mirrors ``repro.models.transformer`` (llama3, gemma with GeGLU and tied
embeddings, qwen3 with qk-norm, qwen1.5's qkv bias, qwen2-vl's M-RoPE
over (B, S, 3) positions, phi3.5-moe and deepseek-moe through
``models.moe``).  The parameter tree has the JAX layout: ``embed`` (V,
d), ``final_norm`` (d,), ``unembed`` (d, V) unless tied, and ``layers``
with every leaf stacked along a leading L axis (``mlp``, or ``moe`` in
the MoE family).  The JAX ``lax.scan`` over layers becomes a Python loop
over views of the stacked leaves; remat and ``layer_block`` are training
memory policies and do not carry over.  ``_layer_fwd`` keeps the full
and q-chunked attention modes; its cache-writing decode mode, which no
JAX caller uses, is left out (``decode_step`` has its own).  The other
families have modules of their own: ``models.hybrid``, ``models.rwkv``
and ``models.encdec``.

The forwards take parameters already in ``cfg.compute_dtype`` and raise
otherwise: serving casts once (``serve.lm.load_serving_params``), where
the JAX forwards cast on every call.  ``lm_loss`` is the training entry:
it casts f32 master weights to the compute dtype with a differentiable
cast, so the gradients reach the f32 leaves as under ``jax.grad``.
"""
from __future__ import annotations

import torch

from repro_torch.core.chgnet import resolve_device

from .config import LMConfig
from .layers import (
    Maker,
    pspec,
    cast_floats,
    attention_chunked,
    attention_decode_merge,
    attention_full,
    attn_init,
    attn_qkv,
    cross_entropy,
    gated_mlp_apply,
    gated_mlp_init,
    rms_norm,
)
from .moe import moe_apply, moe_init


def require_family(cfg: LMConfig, families: tuple, module: str) -> None:
    """Raise unless ``cfg``'s family is one of ``families``, the ones
    ``models.<module>`` runs."""
    if cfg.family not in families:
        raise ValueError(
            f"{cfg.name}: models.{module} runs the {'/'.join(families)} "
            f"families, not {cfg.family!r}; use models.api.family_fns")


def require_ported(cfg: LMConfig) -> None:
    """Raise unless ``cfg`` is a decoder of this module's families: dense,
    MoE or VLM (the others run in ``models.hybrid``, ``models.rwkv`` and
    ``models.encdec``)."""
    require_family(cfg, ("dense", "moe", "vlm"), "transformer")


def _float_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _float_leaves(v)
    elif tree.is_floating_point():
        yield tree


def _check_params(cfg: LMConfig, params) -> None:
    want = getattr(torch, cfg.compute_dtype)
    bad = {t.dtype for t in _float_leaves(params)} - {want}
    if bad:
        raise TypeError(
            f"{cfg.name}: parameters in {sorted(map(str, bad))}, but "
            f"compute_dtype is {cfg.compute_dtype}; cast them once "
            "(serve.lm.load_serving_params)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def decoder_init(cfg: LMConfig, seed: int = 0, *, device=None, dtype=None):
    """Parameter tree from ``seed`` on ``device`` (``None``: the card;
    ``"meta"``: shapes and dtypes only), each leaf drawn in f32 and
    stored in ``dtype`` (default ``cfg.param_dtype``); the stacked layer
    leaves are drawn whole."""
    require_ported(cfg)
    mk = Maker(seed, resolve_device(device), getattr(torch, cfg.param_dtype)
               if dtype is None else dtype)
    return _decoder_tree(cfg, mk)


def decoder_specs(cfg: LMConfig, mesh_sizes: dict):
    """The spec tuple of every leaf of ``decoder_init``'s tree under JAX's
    layout on a mesh of ``mesh_sizes`` (``repro.models.transformer.
    decoder_specs``); data for the dry run, not a sharding the port runs."""
    require_ported(cfg)
    return _decoder_tree(cfg, Maker(None, mesh_sizes=mesh_sizes))


def _decoder_tree(cfg: LMConfig, mk: Maker):
    n, d, v = cfg.num_layers, cfg.d_model, cfg.padded_vocab
    layers = {
        "ln1": mk.make((d,), (None,), init="ones", stack=n),
        "ln2": mk.make((d,), (None,), init="ones", stack=n),
        "attn": attn_init(mk, d, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
                          qk_norm=cfg.qk_norm, stack=n),
    }
    if cfg.is_moe:
        layers["moe"] = moe_init(mk, cfg, stack=n)
    else:
        layers["mlp"] = gated_mlp_init(mk, d, cfg.d_ff, stack=n)
    # JAX's vocab rule: V over 'model' where it feeds the logits matmul,
    # the untied gather table over the first axis that divides it
    logit_vax = mk.ax("model", v) or mk.first_ax(v)
    params = {
        "embed": mk.make((v, d), (logit_vax if cfg.tie_embeddings
                                  else mk.first_ax(v), None), scale=0.02),
        "final_norm": mk.make((d,), (None,), init="ones"),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = mk.make((d, v), (None, logit_vax),
                                    scale=d ** -0.5)
    return params


def layer_params(layers, i: int):
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


# ---------------------------------------------------------------------------
# layer forward
# ---------------------------------------------------------------------------

def _ffn(cfg: LMConfig, p, x, use_pallas: bool):
    """The residual feed-forward half of a layer: the gated MLP, or the
    MoE layer."""
    h2 = rms_norm(x, p["ln2"])
    if cfg.is_moe:
        return x + moe_apply(p["moe"], h2, cfg, use_pallas=use_pallas)
    return x + gated_mlp_apply(p["mlp"], h2, cfg.activation, use_pallas)


def _layer_fwd(cfg: LMConfig, p, x, positions, *, attn_mode: str,
               chunk: int, use_pallas: bool = False):
    """One pre-norm layer over a whole sequence -> (x, (k, v))."""
    h = rms_norm(x, p["ln1"])
    q, k, v = attn_qkv(p["attn"], h, cfg, positions)
    if attn_mode == "chunked":
        out = attention_chunked(q, k, v, causal=True, chunk=chunk)
    elif attn_mode == "full":
        out = attention_full(q, k, v, causal=True)
    else:
        raise ValueError(f"attn_mode must be 'full' or 'chunked', got "
                         f"{attn_mode!r}")
    b, s = out.shape[:2]
    x = x + out.reshape(b, s, -1) @ p["attn"]["wo"]
    return _ffn(cfg, p, x, use_pallas), (k, v)


# ---------------------------------------------------------------------------
# public forwards
# ---------------------------------------------------------------------------

def _embed(cfg: LMConfig, params, tokens):
    return params["embed"][tokens].to(getattr(torch, cfg.compute_dtype))


def _unembed(cfg: LMConfig, params, x):
    x = rms_norm(x, params["final_norm"])
    table = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ table.to(x.dtype)


def forward_train(cfg: LMConfig, params, tokens, positions, *,
                  attn_mode: str = "full", chunk: int = 1024,
                  use_pallas: bool = False):
    """tokens (B, S) -> logits (B, S, V) in the compute dtype."""
    require_ported(cfg)
    _check_params(cfg, params)
    x = run_layers(cfg, params["layers"], _embed(cfg, params, tokens),
                   positions, attn_mode=attn_mode, chunk=chunk,
                   use_pallas=use_pallas)
    return _unembed(cfg, params, x)


def run_layers(cfg: LMConfig, layers, x, positions, *,
               attn_mode: str = "full", chunk: int = 1024,
               use_pallas: bool = False):
    """Hidden states x (B, S, d) through every layer of the stacked
    ``layers`` in order (the whole stack, or one stage of
    ``distributed.pipeline.split_stages``: a GPipe ``stage_fn``)."""
    for i in range(layers["ln1"].shape[0]):
        x, _ = _layer_fwd(cfg, layer_params(layers, i), x, positions,
                          attn_mode=attn_mode, chunk=chunk,
                          use_pallas=use_pallas)
    return x


def lm_loss(cfg: LMConfig, params, tokens, labels, positions, **fw):
    """Mean next-token cross-entropy (``labels`` are the tokens shifted by
    the caller): logits in f32, logsumexp minus the gold logit.  Float
    leaves are cast to ``cfg.compute_dtype`` first, differentiably (a no-op
    for leaves already in it); ``fw`` goes to ``forward_train``."""
    params = cast_floats(params, getattr(torch, cfg.compute_dtype))
    logits = forward_train(cfg, params, tokens, positions, **fw).float()
    return cross_entropy(logits, labels)


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Empty KV cache: ``k`` / ``v`` (L, B, max_len, Hkv, D), ``pos`` the
    number of filled positions (a Python int)."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": 0}


def cache_specs(cfg: LMConfig, mesh_sizes: dict, *, batch_axes,
                seq_axis: str | None):
    """Spec tuples of the KV cache under JAX's layout: batch over
    ``batch_axes``, the sequence over ``seq_axis`` where the KV heads do
    not divide the model axis (``repro.models.transformer.cache_specs``)."""
    head_ax = Maker(None, mesh_sizes=mesh_sizes).head_ax(cfg.num_kv_heads)
    kv = pspec(None, batch_axes, seq_axis if head_ax is None else None,
               head_ax, None)
    return {"k": kv, "v": kv, "pos": ()}


def prefill(cfg: LMConfig, params, tokens, positions, max_len: int, *,
            chunk: int = 1024, use_pallas: bool = False,
            cache_dtype=torch.bfloat16):
    """Forward over the prompt, tokens (B, S) -> (last-position logits
    (B, 1, V), cache of ``max(max_len, S)`` positions, S filled, the rest
    zeros).  Each layer's k / v goes straight into the preallocated cache
    (the JAX version stacks them and pads once; same values)."""
    require_ported(cfg)
    _check_params(cfg, params)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max(max_len, s), cache_dtype, tokens.device)
    x = _embed(cfg, params, tokens)
    for i in range(cfg.num_layers):
        x, (k, v) = _layer_fwd(cfg, layer_params(params["layers"], i), x,
                               positions, attn_mode="chunked", chunk=chunk,
                               use_pallas=use_pallas)
        cache["k"][i, :, :s] = k.to(cache_dtype)
        cache["v"][i, :, :s] = v.to(cache_dtype)
    cache["pos"] = s
    return _unembed(cfg, params, x[:, -1:, :]), cache


def decode_step(cfg: LMConfig, params, tokens, cache, positions, *,
                use_pallas: bool = False):
    """One-token decode: tokens (B, 1) -> (logits (B, 1, V), cache).

    Each layer attends over the cache's first ``pos`` entries merged with
    its own new k / v (``attention_decode_merge``).  The JAX version
    writes every layer's new k / v once after its layer scan, with one
    dynamic-update-slice at ``pos``; here each layer writes its own in
    place after its attention.  The attention reads only the entries
    before ``pos``, so the result is the same; the returned cache shares
    the given one's ``k`` / ``v`` tensors, with ``pos + 1``.
    """
    require_ported(cfg)
    _check_params(cfg, params)
    pos = cache["pos"]
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"the cache is full ({pos} positions)")
    x = _embed(cfg, params, tokens)
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        h = rms_norm(x, lp["ln1"])
        q, k_new, v_new = attn_qkv(lp["attn"], h, cfg, positions)
        out = attention_decode_merge(
            q, k_cache.to(q.dtype), v_cache.to(q.dtype), k_new.to(q.dtype),
            v_new.to(q.dtype), pos)
        k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
        b, s = out.shape[:2]
        x = x + out.reshape(b, s, -1) @ lp["attn"]["wo"]
        x = _ffn(cfg, lp, x, use_pallas)
    logits = _unembed(cfg, params, x)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
