"""Adam / AdamW over a parameter tree, PyTorch port of
``repro.optim.adam`` (paper §IV uses Adam).

``adam_init(params) -> state`` and ``adam_update(grads, state, params,
lr)`` keep the JAX package's arithmetic: ``eps`` is added to
``sqrt(nu / bc2)`` and the bias corrections are taken in f32 from the
step count, so the port does not use ``torch.optim.Adam``.  The update
runs in place under ``torch.no_grad()`` (the JAX package donates the
buffers instead) with multi-tensor ``torch._foreach_*`` ops, each in the
JAX expression's order.  Extra keys of the state dict pass through.

Mixed precision (DESIGN.md §4): ``adam_init(params, master_dtype=...)``
grows an f32 master copy of low-precision parameters in the state
(``state["master"]``); ``adam_update`` then steps the master weights
(the moments are kept at master precision) and writes the cast view
into the live parameters.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.precision import cast_float_tree

from .tree import leaves


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0  # 0 => plain Adam


def adam_init(params, *, master_dtype=None) -> dict:
    """Zero moments like ``params`` and a step count (a CPU int32 scalar:
    host bookkeeping, so the bias corrections need no device read).
    ``master_dtype`` (e.g. ``torch.float32``) adds a master copy of the
    parameters in that dtype, and the moments take it too."""
    ref = params if master_dtype is None \
        else cast_float_tree(params, master_dtype)

    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [zeros(v) for v in t]
        return torch.zeros_like(t, requires_grad=False)

    state = {"mu": zeros(ref), "nu": zeros(ref),
             "count": torch.zeros((), dtype=torch.int32)}
    if master_dtype is not None:
        state["master"] = ref
    return state


@torch.no_grad()
def adam_update(grads, state: dict, params, lr, cfg: AdamConfig = AdamConfig()):
    """One Adam step.  ``params``, ``state["mu"]`` and ``state["nu"]`` are
    updated in place; returns ``(params, state)`` with the count advanced.
    ``grads`` is a tree like ``params`` or the list of its leaves.  With a
    master copy in the state the step runs on it, in its dtype, and the
    parameters receive its cast."""
    master = state.get("master")
    live = leaves(params)
    p = live if master is None else leaves(master)
    # the gradients arrive in the backward's dtype; the moments and the
    # step run at master precision
    g = [x.to(t.dtype) for x, t in zip(leaves(grads), p)]
    mu, nu = leaves(state["mu"]), leaves(state["nu"])
    count = state["count"] + 1
    b1, b2 = cfg.b1, cfg.b2
    # mu = b1 * mu + (1 - b1) * g;  nu = b2 * nu + (1 - b2) * g * g
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
    g2 = torch._foreach_mul(g, 1 - b2)
    torch._foreach_mul_(g2, g)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, g2)
    c = np.float32(count.item())
    bc1 = float(np.float32(1.0) - np.float32(b1) ** c)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** c)
    # upd = (mu / bc1) / (sqrt(nu / bc2) + eps);  p = p - lr * upd
    upd = torch._foreach_div(mu, bc1)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    torch._foreach_div_(upd, den)
    if cfg.weight_decay:
        torch._foreach_add_(upd, torch._foreach_mul(p, cfg.weight_decay))
    torch._foreach_mul_(upd, float(lr))
    torch._foreach_sub_(p, upd)
    if master is not None:
        # live parameters are the cast of the master weights
        for x, t in zip(live, p):
            x.copy_(t)
    return params, dict(state, count=count)
