"""Whisper-style encoder-decoder backbone.

Mirrors ``repro.models.encdec``.  The conv / mel frontend is a stub, as
in JAX: the encoder takes precomputed frame embeddings (B, S_enc,
d_model) and adds sinusoidal positions (``[sin ‖ cos]``, not
interleaved).  Encoder layers are non-causal self-attention and a plain
tanh-GELU MLP; decoder layers add cross-attention on the encoder output
(at decode, on K / V precomputed by ``init_cache``).  Parameters:
``encoder`` and ``decoder`` with leaves stacked along L, ``embed``,
``unembed``, ``enc_final``, ``dec_final``.  JAX's scans over layers become
Python loops and ``init_cache``'s ``vmap`` over the decoder layers a loop;
remat does not carry over.  The MLPs are ungated, so the family runs on
no kernel, as in JAX.  ``pos`` of the cache is a Python int; ``decode_step``
writes each layer's new k / v into the cache in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.chgnet import resolve_device

from .config import LMConfig
from .layers import (
    Maker,
    pspec,
    attention_chunked,
    attention_full,
    attn_init,
    attn_qkv,
    cast_floats,
    cross_entropy,
    plain_mlp_apply,
    plain_mlp_init,
    rms_norm,
)
from .transformer import (
    _check_params,
    _embed,
    layer_params,
    require_family,
)


def sinusoid_pos(s: int, d: int, dtype=torch.float32, device=None):
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=device) / d * math.log(10000.0))
    ang = pos * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _enc_layer_init(mk: Maker, cfg: LMConfig, n: int):
    d = cfg.d_model
    return {
        "ln1": mk.make((d,), (None,), init="ones", stack=n),
        "attn": attn_init(mk, d, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim, stack=n),
        "ln2": mk.make((d,), (None,), init="ones", stack=n),
        "mlp": plain_mlp_init(mk, d, cfg.d_ff, stack=n),
    }


def whisper_init(cfg: LMConfig, seed: int = 0, *, device=None, dtype=None):
    """Parameter tree from ``seed`` on ``device`` (``None``: the card;
    ``"meta"``: shapes only), in ``dtype`` (default ``cfg.param_dtype``);
    JAX's layout."""
    require_family(cfg, ("encdec",), "encdec")
    return _whisper_tree(cfg, Maker(
        seed, resolve_device(device), getattr(torch, cfg.param_dtype)
        if dtype is None else dtype))


def whisper_specs(cfg: LMConfig, mesh_sizes: dict):
    """Spec tuples of ``whisper_init``'s leaves under JAX's layout
    (``repro.models.encdec.whisper_specs``); data for the dry run."""
    require_family(cfg, ("encdec",), "encdec")
    return _whisper_tree(cfg, Maker(None, mesh_sizes=mesh_sizes))


def _whisper_tree(cfg: LMConfig, mk: Maker):
    d, v, n = cfg.d_model, cfg.padded_vocab, cfg.num_decoder_layers
    dec = _enc_layer_init(mk, cfg, n)
    dec["ln_x"] = mk.make((d,), (None,), init="ones", stack=n)
    dec["cross"] = attn_init(mk, d, cfg.num_heads, cfg.num_kv_heads,
                             cfg.resolved_head_dim, stack=n)
    vax = mk.first_ax(v)
    return {
        "embed": mk.make((v, d), (vax, None), scale=0.02),
        "unembed": mk.make((d, v), (None, mk.ax("model", v) or vax),
                           scale=d ** -0.5),
        "enc_final": mk.make((d,), (None,), init="ones"),
        "dec_final": mk.make((d,), (None,), init="ones"),
        "encoder": _enc_layer_init(mk, cfg, cfg.num_layers),
        "decoder": dec,
    }


def _attend(q, k, v, *, causal: bool, attn_mode: str, chunk: int):
    if attn_mode == "chunked":
        return attention_chunked(q, k, v, causal=causal, chunk=chunk)
    if attn_mode == "full":
        return attention_full(q, k, v, causal=causal)
    raise ValueError(f"attn_mode must be 'full' or 'chunked', got "
                     f"{attn_mode!r}")


def encode(cfg: LMConfig, params, frames, *, attn_mode: str = "full",
           chunk: int = 1024):
    """frames: (B, S_enc, d) precomputed embeddings -> the encoder output
    (B, S_enc, d) in the compute dtype."""
    require_family(cfg, ("encdec",), "encdec")
    _check_params(cfg, params)
    x = frames.to(getattr(torch, cfg.compute_dtype))
    x = x + sinusoid_pos(x.shape[1], x.shape[2], x.dtype, x.device)
    for i in range(cfg.num_layers):
        lp = layer_params(params["encoder"], i)
        h = rms_norm(x, lp["ln1"])
        q, k, v = attn_qkv(lp["attn"], h, cfg, None)
        out = _attend(q, k, v, causal=False, attn_mode=attn_mode,
                      chunk=chunk)
        b, s = out.shape[:2]
        x = x + out.reshape(b, s, -1) @ lp["attn"]["wo"]
        x = x + plain_mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"]))
    return rms_norm(x, params["enc_final"])


def _heads(cfg: LMConfig, x, w, kv: bool):
    b, s = x.shape[:2]
    return (x @ w).reshape(b, s, cfg.num_kv_heads if kv else cfg.num_heads,
                           cfg.resolved_head_dim)


def _dec_layer(cfg: LMConfig, lp, x, enc_out, *, attn_mode: str, chunk: int,
               cache=None, pos: int | None = None):
    """One decoder layer: causal self-attention (at decode over the cache
    after writing this token's k / v at ``pos``, in place), cross-attention
    on ``enc_out`` (at decode on the cache's ``xk`` / ``xv``), the MLP."""
    h = rms_norm(x, lp["ln1"])
    q, k, v = attn_qkv(lp["attn"], h, cfg, None)
    if cache is not None:
        cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
        kv_len = torch.full((x.shape[0],), pos + 1, dtype=torch.int32,
                            device=x.device)
        out = attention_full(q, cache["k"].to(q.dtype),
                             cache["v"].to(q.dtype), causal=False,
                             kv_len=kv_len)
    else:
        out = _attend(q, k, v, causal=True, attn_mode=attn_mode, chunk=chunk)
    b, s = out.shape[:2]
    x = x + out.reshape(b, s, -1) @ lp["attn"]["wo"]

    hx = rms_norm(x, lp["ln_x"])
    qx = _heads(cfg, hx, lp["cross"]["wq"], False)
    if cache is not None:
        kx, vx = cache["xk"].to(q.dtype), cache["xv"].to(q.dtype)
    else:
        kx = _heads(cfg, enc_out, lp["cross"]["wk"], True)
        vx = _heads(cfg, enc_out, lp["cross"]["wv"], True)
    outx = attention_full(qx, kx, vx, causal=False)
    x = x + outx.reshape(b, s, -1) @ lp["cross"]["wo"]
    return x + plain_mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"]))


def _dec_embed(cfg: LMConfig, params, tokens, offset: int, table_len: int):
    """Token embeddings plus rows ``offset..`` of a ``table_len``-row
    sinusoid table."""
    x = _embed(cfg, params, tokens)
    table = sinusoid_pos(table_len, x.shape[2], x.dtype, x.device)
    return x + table[offset:offset + x.shape[1]]


def _dec_unembed(params, x):
    x = rms_norm(x, params["dec_final"])
    return x @ params["unembed"].to(x.dtype)


def forward_train(cfg: LMConfig, params, frames, dec_tokens, *,
                  attn_mode: str = "full", chunk: int = 1024):
    """frames (B, S_enc, d), decoder tokens (B, S) -> logits (B, S, V) in
    the compute dtype."""
    enc_out = encode(cfg, params, frames, attn_mode=attn_mode, chunk=chunk)
    x = _dec_embed(cfg, params, dec_tokens, 0, dec_tokens.shape[1])
    for i in range(cfg.num_decoder_layers):
        x = _dec_layer(cfg, layer_params(params["decoder"], i), x, enc_out,
                       attn_mode=attn_mode, chunk=chunk)
    return _dec_unembed(params, x)


def lm_loss(cfg: LMConfig, params, frames, labels, **fw):
    """Teacher-forced cross-entropy: the decoder's input is ``labels``
    shifted right with a 0 in front.  Float leaves cast to
    ``cfg.compute_dtype`` first, differentiably."""
    params = cast_floats(params, getattr(torch, cfg.compute_dtype))
    dec_in = torch.nn.functional.pad(labels[:, :-1], (1, 0))
    logits = forward_train(cfg, params, frames, dec_in, **fw).float()
    return cross_entropy(logits, labels)


def init_cache(cfg: LMConfig, params, enc_out, max_len: int,
               dtype=torch.bfloat16):
    """Empty self-attention cache (L, B, max_len, Hkv, D) and each decoder
    layer's cross K / V of ``enc_out`` (L, B, S_enc, Hkv, D); ``pos`` 0."""
    require_family(cfg, ("encdec",), "encdec")
    _check_params(cfg, params)
    b = enc_out.shape[0]
    shape = (cfg.num_decoder_layers, b, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    xk, xv = [], []
    for i in range(cfg.num_decoder_layers):
        cross = layer_params(params["decoder"], i)["cross"]
        xk.append(_heads(cfg, enc_out, cross["wk"], True).to(dtype))
        xv.append(_heads(cfg, enc_out, cross["wv"], True).to(dtype))
    return {
        "k": torch.zeros(shape, dtype=dtype, device=enc_out.device),
        "v": torch.zeros(shape, dtype=dtype, device=enc_out.device),
        "xk": torch.stack(xk), "xv": torch.stack(xv),
        "pos": 0,
    }


def cache_specs(cfg: LMConfig, mesh_sizes: dict, *, batch_axes,
                seq_axis: str | None):
    """Spec tuples of the decode cache under JAX's layout
    (``repro.models.encdec.cache_specs``): the self and cross K / V as
    ``transformer.cache_specs``'s."""
    head_ax = Maker(None, mesh_sizes=mesh_sizes).head_ax(cfg.num_kv_heads)
    kv = pspec(None, batch_axes, seq_axis if head_ax is None else None,
               head_ax, None)
    return {"k": kv, "v": kv, "xk": kv, "xv": kv, "pos": ()}


def decode_step(cfg: LMConfig, params, tokens, cache):
    """One-token decode: tokens (B, 1) at position ``cache["pos"]`` (its
    row of a ``max_len``-row sinusoid table) -> (logits (B, 1, V), the
    cache with one more position)."""
    require_family(cfg, ("encdec",), "encdec")
    _check_params(cfg, params)
    pos = cache["pos"]
    max_len = cache["k"].shape[2]
    if pos >= max_len:
        raise ValueError(f"the cache is full ({pos} positions)")
    x = _dec_embed(cfg, params, tokens, pos, max_len)
    for i in range(cfg.num_decoder_layers):
        layer_cache = {k: cache[k][i] for k in ("k", "v", "xk", "xv")}
        x = _dec_layer(cfg, layer_params(params["decoder"], i), x, None,
                       attn_mode="full", chunk=0, cache=layer_cache, pos=pos)
    return _dec_unembed(params, x), dict(cache, pos=pos + 1)
