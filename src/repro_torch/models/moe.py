"""Mixture-of-Experts layer: top-k routing, sort-based capacity dispatch,
stacked expert weights, optional always-on shared experts (DeepSeek-MoE).

Mirrors ``repro.models.moe``.  Tokens are grouped by sequence; each group
has a static expert capacity ``C = max(k, int(S * k * capacity_factor /
E))`` and the tokens past it drop.  Dispatch sorts the (token, choice)
pairs by expert (a stable sort, as JAX's ``argsort``: stability decides
which tokens overflow), ranks them within their expert, and scatters each
kept one into its slot of an (E * C + 1, d) buffer whose last row takes
every dropped token and is discarded.  Only kept slots are unique, so the
order of the duplicate writes to the spare row decides nothing.  The JAX
``vmap`` over groups becomes a batched leading axis.

The combine inverts the sort: every token owns exactly k slots, so its k
rows are gathered back into (B, S, k, d) and summed over k in a fixed
order.  JAX's scatter-add over tokens would be ``index_add_`` here, which
adds with atomics on the card; the gathers' backwards write each kept row
once.  What the JAX module adds for the TPU mesh (``moe_axes``' sharding
anchors) is left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Maker, gated_mlp_apply, gated_mlp_init


def moe_init(mk: Maker, cfg, *, stack: int | None = None):
    d = cfg.d_model
    m = cfg.moe
    e, fe = m.num_experts, m.d_ff_expert
    p = {
        "router": mk.make((d, e), (None, mk.ax("model", e)),
                          scale=d ** -0.5, stack=stack),
        "we_gate": mk.make((e, d, fe), (mk.ax("model", e), mk.ax("data", d),
                                        None), stack=stack),
        "we_up": mk.make((e, d, fe), (mk.ax("model", e), mk.ax("data", d),
                                      None), stack=stack),
        "we_down": mk.make((e, fe, d), (mk.ax("model", e), None,
                                        mk.ax("data", d)), stack=stack),
    }
    if m.num_shared:
        p["shared"] = gated_mlp_init(mk, d, m.num_shared * fe, stack=stack)
    return p


def capacity(cfg, s: int) -> int:
    """Slots per expert and group of ``s`` tokens (Python's ``int`` of the
    float, as in JAX)."""
    m = cfg.moe
    return max(m.top_k, int(s * m.top_k * m.capacity_factor / m.num_experts))


def route(p, x, cfg):
    """Router logits in the compute dtype, softmax in f32, top-k, the gates
    renormalised (``+ 1e-9``) and cast back: x (B, S, d) -> gate (B, S, k)
    in ``x.dtype``, expert ids (B, S, k)."""
    probs = torch.softmax((x @ p["router"]).to(torch.float32), dim=-1)
    gate, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    return gate.to(x.dtype), idx


def dispatch(x, idx, num_experts: int, cap: int):
    """Sort-based dispatch of each group (row of the batch).

    x (B, T, d), idx (B, T, k) -> expert inputs (B, E, C, d) and, per
    (token, choice) pair in the flat ``t * k + j`` order, its slot in the
    flattened (E * C + 1) buffer (``E * C`` when dropped) and whether it
    was kept."""
    b, t, k = idx.shape
    d = x.shape[-1]
    n = t * k
    sorted_e, order = torch.sort(idx.reshape(b, n), dim=-1, stable=True)
    pos = torch.arange(n, device=x.device).expand(b, n)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    group_start = torch.cummax(torch.where(is_start, pos, 0), dim=-1).values
    rank = pos - group_start                  # rank within its expert
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank, num_experts * cap)
    # the pairs in sorted order read their token's row: a permutation of
    # the k-fold repeated rows, so the backward writes each row once
    x_rep = x.repeat_interleave(k, dim=1)               # (B, T*k, d)
    src = x_rep.gather(1, order[..., None].expand(b, n, d))
    buf = x.new_zeros((b, num_experts * cap + 1, d)).scatter(
        1, slot[..., None].expand(b, n, d), src)
    expert_in = buf[:, :-1].reshape(b, num_experts, cap, d)
    inv = torch.argsort(order, dim=-1)
    return expert_in, slot.gather(1, inv), keep.gather(1, inv)


def combine(expert_out, slot, keep, gate):
    """(B, E, C, d) expert outputs -> (B, T, d): each token's k rows,
    weighted by its gates (dropped ones by 0), summed over k in order."""
    b = expert_out.shape[0]
    d = expert_out.shape[-1]
    t, k = gate.shape[1], gate.shape[2]
    flat = expert_out.reshape(b, -1, d)
    flat = torch.cat([flat, flat.new_zeros((b, 1, d))], dim=1)
    rows = flat.gather(1, slot[..., None].expand(b, t * k, d))
    w = gate.reshape(b, t * k) * keep.to(gate.dtype)
    return (rows * w[..., None]).reshape(b, t, k, d).sum(dim=2)


def moe_apply(p, x, cfg, *, use_pallas: bool = False):
    """x (B, S, d) -> (B, S, d); groups are the sequences.  The expert
    products are einsums over the stacked weights; ``use_pallas`` runs
    the shared experts through the fused feed-forward kernel
    (``kernels.ops.fused_swiglu``)."""
    m = cfg.moe
    gate, idx = route(p, x, cfg)
    expert_in, slot, keep = dispatch(x, idx, m.num_experts,
                                     capacity(cfg, x.shape[1]))
    g = torch.einsum("becd,edf->becf", expert_in, p["we_gate"])
    u = torch.einsum("becd,edf->becf", expert_in, p["we_up"])
    expert_out = torch.einsum("becf,efd->becd", F.silu(g) * u, p["we_down"])
    y = combine(expert_out, slot, keep, gate)
    if m.num_shared:
        y = y + gated_mlp_apply(p["shared"], x, "silu", use_pallas)
    return y
