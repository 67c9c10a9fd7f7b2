"""Zamba2-style hybrid: a Mamba2 backbone with one SHARED-weight attention
block applied after every ``attn_every``-th layer (weights shared, a KV
cache per application site).

Mirrors ``repro.models.hybrid`` on its parameter layout (``layers``
stacked along L: ``ln`` and ``mamba``; ``shared``: ``ln1``, ``attn``,
``ln2``, ``mlp``).  JAX's ``lax.scan`` over the Mamba layers with a
``lax.cond`` on ``i % attn_every == attn_every - 1`` becomes a Python loop
with an ``if``, and the site's cache index is ``i // attn_every``.  The
shared block's gated MLP takes ``use_pallas`` as the dense decoder's
does: ``serve.lm``'s steps run it on the fused feed-forward kernel
(``kernels.ops.fused_swiglu``); ``use_pallas=False`` is JAX's
computation.  Remat is a training memory policy and does not carry over.
The decode state's ``pos`` is a Python int, as in ``models.transformer``;
``decode_step`` writes each site's new k / v into the cache in place and
returns new Mamba states.
"""
from __future__ import annotations

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
    gated_mlp_apply,
    gated_mlp_init,
    rms_norm,
)
from .ssm import mamba_decode_step, mamba_fwd, mamba_init, mamba_init_state
from .transformer import (
    _check_params,
    _embed,
    _unembed,
    layer_params,
    require_family,
)


def num_attn_sites(cfg: LMConfig) -> int:
    return cfg.num_layers // cfg.attn_every


def zamba_init(cfg: LMConfig, seed: int = 0, *, device=None, dtype=None):
    """Parameter tree from ``seed`` on ``device`` (``None``: the card;
    ``"meta"``: shapes only), in ``dtype`` (default ``cfg.param_dtype``);
    JAX's layout."""
    require_family(cfg, ("hybrid",), "hybrid")
    return _zamba_tree(cfg, Maker(
        seed, resolve_device(device), getattr(torch, cfg.param_dtype)
        if dtype is None else dtype))


def zamba_specs(cfg: LMConfig, mesh_sizes: dict):
    """Spec tuples of ``zamba_init``'s leaves under JAX's layout
    (``repro.models.hybrid.zamba_specs``); data for the dry run."""
    require_family(cfg, ("hybrid",), "hybrid")
    return _zamba_tree(cfg, Maker(None, mesh_sizes=mesh_sizes))


def _zamba_tree(cfg: LMConfig, mk: Maker):
    n, d, v = cfg.num_layers, cfg.d_model, cfg.padded_vocab
    layers = {"ln": mk.make((d,), (None,), init="ones", stack=n),
              "mamba": mamba_init(mk, cfg, stack=n)}
    shared = {
        "ln1": mk.make((d,), (None,), init="ones"),
        "attn": attn_init(mk, d, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim),
        "ln2": mk.make((d,), (None,), init="ones"),
        "mlp": gated_mlp_init(mk, d, cfg.d_ff),
    }
    vax = mk.first_ax(v)
    return {
        "embed": mk.make((v, d), (vax, None), scale=0.02),
        "unembed": mk.make((d, v), (None, mk.ax("model", v) or vax),
                           scale=d ** -0.5),
        "final_norm": mk.make((d,), (None,), init="ones"),
        "layers": layers,
        "shared": shared,
    }


def _is_site(cfg: LMConfig, i: int) -> bool:
    return i % cfg.attn_every == cfg.attn_every - 1


def _shared_mlp(cfg, sp, x, use_pallas: bool):
    return x + gated_mlp_apply(sp["mlp"], rms_norm(x, sp["ln2"]), "silu",
                               use_pallas)


def _shared_attn_fwd(cfg, sp, x, positions, *, attn_mode: str, chunk: int,
                     use_pallas: bool = False):
    """The shared block over a sequence -> (x, (k, v))."""
    h = rms_norm(x, sp["ln1"])
    q, k, v = attn_qkv(sp["attn"], h, cfg, positions)
    if attn_mode == "chunked":
        out = attention_chunked(q, k, v, causal=True, chunk=chunk)
    elif attn_mode == "full":
        out = attention_full(q, k, v, causal=True)
    else:
        raise ValueError(f"attn_mode must be 'full' or 'chunked', got "
                         f"{attn_mode!r}")
    b, s = out.shape[:2]
    x = x + out.reshape(b, s, -1) @ sp["attn"]["wo"]
    return _shared_mlp(cfg, sp, x, use_pallas), (k, v)


def forward_train(cfg: LMConfig, params, tokens, positions, *,
                  attn_mode: str = "full", chunk: int = 1024,
                  ssd_chunk: int = 128, use_pallas: bool = False):
    """tokens (B, S) -> logits (B, S, V) in the compute dtype."""
    require_family(cfg, ("hybrid",), "hybrid")
    _check_params(cfg, params)
    x = _embed(cfg, params, tokens)
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        x = x + mamba_fwd(lp["mamba"], rms_norm(x, lp["ln"]), cfg,
                          chunk=ssd_chunk)
        if _is_site(cfg, i):
            x, _ = _shared_attn_fwd(cfg, params["shared"], x, positions,
                                    attn_mode=attn_mode, chunk=chunk,
                                    use_pallas=use_pallas)
    return _unembed(cfg, params, x)


def lm_loss(cfg: LMConfig, params, tokens, labels, positions, **fw):
    """Mean next-token cross-entropy; float leaves cast to
    ``cfg.compute_dtype`` first, differentiably (``transformer.lm_loss``);
    ``fw`` goes to ``forward_train`` (``ssd_chunk``, ...)."""
    params = cast_floats(params, getattr(torch, cfg.compute_dtype))
    logits = forward_train(cfg, params, tokens, positions, **fw).float()
    return cross_entropy(logits, labels)


# ---------------------------------------------------------------------------
# decode: per-layer mamba states + per-site attention KV caches
# ---------------------------------------------------------------------------

def init_state(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Empty decode state: ``mamba`` (every leaf stacked along L; ``ssm``
    f32), ``k`` / ``v`` (sites, B, max_len, Hkv, D), ``pos`` 0."""
    dev = resolve_device(device)
    one = mamba_init_state(cfg, batch, dtype, dev)
    shape = (num_attn_sites(cfg), batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {
        "mamba": {k: v.expand(cfg.num_layers, *v.shape).clone()
                  for k, v in one.items()},
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "pos": 0,
    }


def state_specs(cfg: LMConfig, mesh_sizes: dict, *, batch_axes,
                seq_axis: str | None):
    """Spec tuples of ``init_state``'s leaves under JAX's layout
    (``repro.models.hybrid.state_specs``)."""
    head_ax = Maker(None, mesh_sizes=mesh_sizes).head_ax(cfg.num_kv_heads)
    kv = pspec(None, batch_axes, seq_axis if head_ax is None else None,
               head_ax, None)
    return {
        "mamba": {"ssm": pspec(None, batch_axes, None, None, None),
                  "conv": pspec(None, batch_axes, None, None)},
        "k": kv, "v": kv, "pos": (),
    }


def prefill(cfg: LMConfig, params, tokens, positions, max_len: int, *,
            chunk: int = 1024, ssd_chunk: int = 128,
            cache_dtype=torch.bfloat16, use_pallas: bool = False):
    """Run the prompt: (last-position logits (B, 1, V), decode state) with
    every layer's Mamba state and each site's k / v in a cache of
    ``max(max_len, S)`` positions, S filled."""
    require_family(cfg, ("hybrid",), "hybrid")
    _check_params(cfg, params)
    b, s = tokens.shape
    state = init_state(cfg, b, max(max_len, s), cache_dtype, tokens.device)
    x = _embed(cfg, params, tokens)
    ssm, conv = [], []
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        y, mst = mamba_fwd(lp["mamba"], rms_norm(x, lp["ln"]), cfg,
                           chunk=ssd_chunk, return_state=True)
        x = x + y
        ssm.append(mst["ssm"])
        conv.append(mst["conv"])
        if _is_site(cfg, i):
            x, (k, v) = _shared_attn_fwd(
                cfg, params["shared"], x, positions, attn_mode="chunked",
                chunk=chunk, use_pallas=use_pallas)
            site = i // cfg.attn_every
            state["k"][site, :, :s] = k.to(cache_dtype)
            state["v"][site, :, :s] = v.to(cache_dtype)
    state["mamba"] = {"ssm": torch.stack(ssm), "conv": torch.stack(conv)}
    state["pos"] = s
    return _unembed(cfg, params, x[:, -1:, :]), state


def _shared_attn_decode(cfg, sp, x, k_cache, v_cache, pos: int, positions,
                        use_pallas: bool):
    """The shared block on one token: its k / v written at ``pos`` (in
    place), then attention over the cache's first ``pos + 1`` entries."""
    h = rms_norm(x, sp["ln1"])
    q, k, v = attn_qkv(sp["attn"], h, cfg, positions)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    kv_len = torch.full((x.shape[0],), pos + 1, dtype=torch.int32,
                        device=x.device)
    out = attention_full(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                         causal=False, kv_len=kv_len)
    b, s = out.shape[:2]
    x = x + out.reshape(b, s, -1) @ sp["attn"]["wo"]
    return _shared_mlp(cfg, sp, x, use_pallas)


def decode_step(cfg: LMConfig, params, tokens, state, positions, *,
                use_pallas: bool = False):
    """tokens (B, 1) -> (logits (B, 1, V), new state): the Mamba layers'
    one-step recurrences, the shared block at its sites."""
    require_family(cfg, ("hybrid",), "hybrid")
    _check_params(cfg, params)
    pos = state["pos"]
    if pos >= state["k"].shape[2]:
        raise ValueError(f"the cache is full ({pos} positions)")
    x = _embed(cfg, params, tokens)
    ssm, conv = [], []
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        mst = {k: v[i] for k, v in state["mamba"].items()}
        y, new = mamba_decode_step(lp["mamba"], rms_norm(x, lp["ln"]), mst,
                                   cfg)
        x = x + y
        ssm.append(new["ssm"])
        conv.append(new["conv"])
        if _is_site(cfg, i):
            site = i // cfg.attn_every
            x = _shared_attn_decode(cfg, params["shared"], x,
                                    state["k"][site], state["v"][site], pos,
                                    positions, use_pallas)
    logits = _unembed(cfg, params, x)
    return logits, {"mamba": {"ssm": torch.stack(ssm),
                              "conv": torch.stack(conv)},
                    "k": state["k"], "v": state["v"], "pos": pos + 1}
