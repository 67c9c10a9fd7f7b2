"""RWKV6 ("Finch") full model: attention-free LM with data-dependent decay.

Mirrors ``repro.models.rwkv`` on its parameter layout (``layers`` stacked
along L).  Decode is O(1) in context length: the state (per layer ``wkv``
(B, H, K, V) f32 and the last token of each mix, ``tm_prev`` /
``cm_prev`` (B, 1, d)) has a fixed size.  ``prefill`` returns the states
stacked along L, as JAX's scan returns them.  JAX's ``lax.scan`` over
layers becomes a Python loop; the layer remat does not carry over (the
time scan's chunk checkpoints do: ``models.ssm``).  The family has no
gated MLP (the channel mix is a squared-ReLU MLP), so it runs on no
kernel, as in JAX.
"""
from __future__ import annotations

import torch

from repro_torch.core.chgnet import resolve_device

from .config import LMConfig
from .layers import Maker, cast_floats, cross_entropy, pspec, rms_norm
from .ssm import rwkv_init_state, rwkv_layer_fwd, rwkv_layer_init
from .transformer import (
    _check_params,
    _embed,
    _unembed,
    layer_params,
    require_family,
)


def rwkv_init(cfg: LMConfig, seed: int = 0, *, device=None, dtype=None):
    """Parameter tree from ``seed`` on ``device`` (``None``: the card;
    ``"meta"``: shapes only), in ``dtype`` (default ``cfg.param_dtype``);
    JAX's layout."""
    require_family(cfg, ("rwkv",), "rwkv")
    return _rwkv_tree(cfg, Maker(
        seed, resolve_device(device), getattr(torch, cfg.param_dtype)
        if dtype is None else dtype))


def rwkv_specs(cfg: LMConfig, mesh_sizes: dict):
    """Spec tuples of ``rwkv_init``'s leaves under JAX's layout
    (``repro.models.rwkv.rwkv_specs``); data for the dry run."""
    require_family(cfg, ("rwkv",), "rwkv")
    return _rwkv_tree(cfg, Maker(None, mesh_sizes=mesh_sizes))


def _rwkv_tree(cfg: LMConfig, mk: Maker):
    d, v = cfg.d_model, cfg.padded_vocab
    vax = mk.first_ax(v)
    return {
        "embed": mk.make((v, d), (vax, None), scale=0.02),
        "unembed": mk.make((d, v), (None, mk.ax("model", v) or vax),
                           scale=d ** -0.5),
        "final_norm": mk.make((d,), (None,), init="ones"),
        "layers": rwkv_layer_init(mk, cfg, stack=cfg.num_layers),
    }


def rwkv_init_states(cfg: LMConfig, batch: int, dtype=torch.float32,
                     device=None):
    """Zero states of every layer, stacked along L."""
    one = rwkv_init_state(cfg, batch, dtype, resolve_device(device))
    return {k: v.expand(cfg.num_layers, *v.shape).clone()
            for k, v in one.items()}


def state_specs(cfg: LMConfig, batch_axes):
    """Spec tuples of ``rwkv_init_states``' leaves under JAX's layout
    (``repro.models.rwkv.state_specs``): batch over ``batch_axes``."""
    return {"wkv": pspec(None, batch_axes, None, None, None),
            "tm_prev": pspec(None, batch_axes, None, None),
            "cm_prev": pspec(None, batch_axes, None, None)}


def _layers(cfg, params, x, states=None):
    """Every layer over x from zero states (``states=None``) or from the
    stacked ``states`` -> (x, the layers' new states stacked along L)."""
    if states is None:
        state0 = rwkv_init_state(cfg, x.shape[0], x.dtype, x.device)
    new = []
    for i in range(cfg.num_layers):
        st = state0 if states is None else \
            {k: v[i] for k, v in states.items()}
        x, st = rwkv_layer_fwd(layer_params(params["layers"], i), x, cfg,
                               st)
        new.append(st)
    return x, {k: torch.stack([st[k] for st in new]) for k in new[0]}


def forward_train(cfg: LMConfig, params, tokens, positions=None):
    """tokens (B, S) -> logits (B, S, V) in the compute dtype (positions
    unused: the family has none)."""
    require_family(cfg, ("rwkv",), "rwkv")
    _check_params(cfg, params)
    x, _ = _layers(cfg, params, _embed(cfg, params, tokens))
    return _unembed(cfg, params, x)


def lm_loss(cfg: LMConfig, params, tokens, labels, positions=None, **fw):
    """Mean next-token cross-entropy; float leaves cast to
    ``cfg.compute_dtype`` first, differentiably."""
    params = cast_floats(params, getattr(torch, cfg.compute_dtype))
    logits = forward_train(cfg, params, tokens, positions, **fw).float()
    return cross_entropy(logits, labels)


def prefill(cfg: LMConfig, params, tokens, positions=None):
    """Run the prompt: (last-position logits (B, 1, V), the layers' final
    states stacked along L)."""
    require_family(cfg, ("rwkv",), "rwkv")
    _check_params(cfg, params)
    x, states = _layers(cfg, params, _embed(cfg, params, tokens))
    return _unembed(cfg, params, x[:, -1:, :]), states


def decode_step(cfg: LMConfig, params, tokens, states, positions=None):
    """One-token decode: tokens (B, 1) and the stacked states -> (logits
    (B, 1, V), new stacked states)."""
    require_family(cfg, ("rwkv",), "rwkv")
    _check_params(cfg, params)
    x, states = _layers(cfg, params, _embed(cfg, params, tokens), states)
    return _unembed(cfg, params, x), states
