"""Plain PyTorch versions of the hand-written kernels (ground truth).

Mirrors ``repro.kernels.ref`` function for function.  The op wrappers in
``repro_torch.kernels.ops`` run these on CPU tensors; on the card they
are the yardstick the CUDA kernels are held against.  The reductions use
``index_add_``, which on CUDA uses atomics: fine for a yardstick of
correctness, never used by a kernel.

The convs and the force readout (kernels 2, 3 and 4a) also take bf16
operands, as the JAX kernels do in interpret mode: every operand is
widened to f32 (exactly), the GEMM, both LayerNorms, the gate, the
envelopes and the sums run in f32, and the result is rounded to the
operand dtype once, at the end (not ``gated_mlp_packed_ref`` run in bf16,
which would round after every op).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _layer_norm(x, scale, bias, eps=1e-5):
    # population variance (jnp.var), statistics in f32
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def integer_pow(x, n: int):
    """x**n (n >= 1) by repeated squaring, in the multiplication order of
    JAX's ``integer_pow`` and of the CUDA RBF kernel: the envelopes cancel
    to ~1e-4 near the cutoff, where the rounding of the powers shows."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def envelope(xi, p: int = 8):
    """Factored smooth-cutoff envelope (Eq. 13, Horner form)."""
    inner = (p + 1.0) * (p + 2.0) + xi * (
        -2.0 * p * (p + 2.0) + xi * (p * (p + 1.0)))
    return 1.0 - 0.5 * integer_pow(xi, p) * inner


def fused_rbf_ref(dist, freqs, r_cut: float, p: int = 8):
    """(N,) x (K,) -> (N, K) smooth radial Bessel basis."""
    xi = dist / r_cut
    u = envelope(xi, p)
    r_safe = torch.where(dist > 1e-8, dist, torch.ones_like(dist))
    val = math.sqrt(2.0 / r_cut) * torch.sin(xi[:, None] * freqs[None, :])
    return val / r_safe[:, None] * u[:, None]


def fused_fourier_ref(theta, num_basis: int):
    """(N,) -> (N, num_basis): [1/sqrt(2), cos(n t), sin(n t)] / sqrt(pi)."""
    harmonics = (num_basis - 1) // 2
    n = torch.arange(1, harmonics + 1, dtype=theta.dtype, device=theta.device)
    ang = theta[:, None] * n
    dc = torch.full((theta.shape[0], 1), 1.0 / math.sqrt(2.0),
                    dtype=theta.dtype, device=theta.device)
    out = torch.cat([dc, torch.cos(ang), torch.sin(ang)], dim=-1)
    return out / math.sqrt(math.pi)


def sorted_segment_sum_ref(values, seg_ids, offsets, num_segments):
    """(E, D) x (E,) x (S+1,) -> (S, D) sorted-segment reduction.

    ``offsets[num_segments]`` delimits the real edges; the padded tail
    (whatever its segment ids) contributes nothing: it is zeroed before
    the scatter-add.
    """
    valid = torch.arange(values.shape[0], device=values.device) \
        < offsets[num_segments]
    v = torch.where(valid[:, None], values,
                    torch.zeros((), dtype=values.dtype, device=values.device))
    return _segment_sum(v, seg_ids, num_segments)


def gated_mlp_packed_ref(x, w, b, ln_scale, ln_bias):
    """Packed-parameter GatedMLP: w = [Wc ‖ Wg], b/ln_* = [core ‖ gate]."""
    d = w.shape[1] // 2
    y = x @ w + b
    core = _layer_norm(y[..., :d], ln_scale[:d], ln_bias[:d])
    gate = _layer_norm(y[..., d:], ln_scale[d:], ln_bias[d:])
    return F.silu(core) * torch.sigmoid(gate)


def gather_rows(table, ids):
    """``table[ids]`` for a 2-D table, as ``F.embedding``.  Same values;
    on CUDA its backward sums the rows of a repeated id in parallel
    segments, where indexing's backward (``index_put_`` with accumulation)
    walks all of them in one warp.  Padded bonds and angles all carry id
    0, hundreds of thousands of times in a training batch."""
    return F.embedding(ids, table)


def _widen(*tensors):
    """f32 views of bf16 operands; f32 and float64 ones pass through."""
    return [t.float() if t.dtype == torch.bfloat16 else t for t in tensors]


def _mask_real_edges(msg, offsets):
    """Zero everything past offsets[-1] (the real-edge count, DESIGN.md §1)."""
    valid = torch.arange(msg.shape[0], device=msg.device) < offsets[-1]
    return torch.where(valid[:, None], msg, torch.zeros((), dtype=msg.dtype,
                                                        device=msg.device))


def _segment_sum(values, ids, num_segments):
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add_(0, ids.long(), values)


def scatter_rows(values, ids, num_rows):
    """``out[r] = sum of values[t] over ids[t] == r`` for unsorted ids: the
    transpose of ``gather_rows`` (``F.embedding``'s backward), which sorts
    the ids and sums each id's rows in a fixed order, so the result is the
    same from run to run on the card, where ``index_add_`` adds in the
    order its atomics land.  Differentiable (its backward is a gather)."""
    return torch.ops.aten.embedding_dense_backward(
        values, ids, num_rows, -1, False)


def fused_atom_conv_ref(v, e, e_a, w, b, ln_scale, ln_bias,
                        bond_center, bond_nbr, offsets, pair=None,
                        und_features=False):
    """Unfused Eq. 4 message path: gather-concat -> GatedMLP -> envelope ->
    segment reduce -> (A, D).

    ``pair`` (the undirected store, DESIGN.md §5): ``e_a`` is the (Eu, D)
    envelope table, read through the mirror map.  ``und_features`` (the
    symmetric trunk, §10): ``e`` is an (Eu, D) table too.  bf16 operands:
    f32 inside, the result rounded to bf16 once."""
    dtype = v.dtype
    v, e, e_a, w, b, ln_scale, ln_bias = _widen(v, e, e_a, w, b, ln_scale,
                                                ln_bias)
    e_dir = gather_rows(e, pair) if und_features else e
    x = torch.cat([gather_rows(v, bond_center), gather_rows(v, bond_nbr),
                   e_dir], dim=-1)
    env = e_a if pair is None else gather_rows(e_a, pair)
    msg = gated_mlp_packed_ref(x, w, b, ln_scale, ln_bias) * env
    msg = _mask_real_edges(msg, offsets)
    return _segment_sum(msg, bond_center, v.shape[0]).to(dtype)


def fused_bond_conv_ref(v, e, a, e_b, w, b, ln_scale, ln_bias,
                        angle_ij, angle_ik, center_ids, offsets, pair=None):
    """Unfused Eq. 5 message path -> (E, D) (``center_ids =
    bond_center[angle_ij]``, precomputed by the caller).  ``pair``: ``e_b``
    is the (Eu, D) envelope table, both factors read through
    ``pair[angle_*]``.  bf16 operands: f32 inside, rounded once."""
    dtype = e.dtype
    v, e, a, e_b, w, b, ln_scale, ln_bias = _widen(v, e, a, e_b, w, b,
                                                   ln_scale, ln_bias)
    x = torch.cat([gather_rows(v, center_ids), gather_rows(e, angle_ij),
                   gather_rows(e, angle_ik), a], dim=-1)
    msg = gated_mlp_packed_ref(x, w, b, ln_scale, ln_bias)
    env_ij, env_ik = (angle_ij, angle_ik) if pair is None else \
        (pair[angle_ij.long()], pair[angle_ik.long()])
    msg = msg * gather_rows(e_b, env_ij) * gather_rows(e_b, env_ik)
    msg = _mask_real_edges(msg, offsets)
    return _segment_sum(msg, angle_ij, e.shape[0]).to(dtype)


def sym_msg_ref(v, e, a_u, e_b, w, b, ln_scale, ln_bias, ctr, du1, du2):
    """Phase A of the symmetric bond conv (DESIGN.md §10): one message per
    dedup angle row w, ``phi([v[ctr] | e_s | e_s | a_u[w]]) * e_b[du1] *
    e_b[du2]`` with the swap-symmetric ``e_s = e[du1] + e[du2]`` -> (Au, D).
    Every row is computed; rows past the real prefix are finite values
    that phase B never reads."""
    e_s = gather_rows(e, du1) + gather_rows(e, du2)
    x = torch.cat([gather_rows(v, ctr), e_s, e_s, a_u], dim=-1)
    return gated_mlp_packed_ref(x, w, b, ln_scale, ln_bias) \
        * gather_rows(e_b, du1) * gather_rows(e_b, du2)


def sym_accum_ref(msg, rep, dest, offsets, eu_rows):
    """Phase B: ``out[u] = sum of msg[rep[t]]`` over u's incidences t in
    ``[offsets[u], offsets[u+1])`` -> (Eu, D); the padded incidences past
    ``offsets[-1]`` (rep 0, a real row) add nothing."""
    incid = _mask_real_edges(gather_rows(msg, rep), offsets)
    return _segment_sum(incid, dest, eu_rows)


def fused_sym_bond_conv_ref(v, e, a_u, e_b, w, b, ln_scale, ln_bias,
                            ctr, du1, du2, rep, dest, offsets):
    """Symmetrized Eq. 5 message path (DESIGN.md §10) -> (Eu, D): the
    phase-A messages scattered to both undirected bonds of their pair (one
    bond twice for a self-image pair) through the dest-sorted incidence
    store."""
    msg = sym_msg_ref(v, e, a_u, e_b, w, b, ln_scale, ln_bias, ctr, du1, du2)
    return sym_accum_ref(msg, rep, dest, offsets, e.shape[0])


def fused_force_readout_ref(e, x_hat, w1, b1, w2, b2, bond_center, offsets,
                            num_atoms):
    """Unfused Eq. 7: per-bond scalar MLP -> n_ij * x_hat_ij -> atom reduce.
    bf16 operands: f32 inside, the forces rounded to bf16 once."""
    dtype = e.dtype
    e, x_hat, w1, b1, w2, b2 = _widen(e, x_hat, w1, b1, w2, b2)
    h = F.silu(e @ w1 + b1)
    n = (h @ w2 + b2)[..., 0]
    contrib = _mask_real_edges(n[:, None] * x_hat, offsets)
    return _segment_sum(contrib, bond_center, num_atoms).to(dtype)


def fused_force_virial_readout_ref(e, x_hat, dist, w1, b1, w2, b2,
                                   bond_center, bond_crystal, offsets,
                                   num_atoms, num_crystals):
    """Unfused force readout + bond-virial partials (DESIGN.md §7).

    Same per-bond scalar n_ij as ``fused_force_readout_ref``; the second
    output sums, per crystal over the real edges,

        raw_c = sum_{ij in c} n_ij d_ij x_hat_ij ⊗ x_hat_ij   (B, 3, 3) f32.

    Volume normalization and units live in ``core.heads``.
    """
    h = F.silu(e @ w1 + b1)
    n = (h @ w2 + b2)[..., 0]
    contrib = _mask_real_edges(n[:, None] * x_hat, offsets)
    forces = _segment_sum(contrib, bond_center, num_atoms)
    outer = (x_hat[:, :, None] * x_hat[:, None, :]).reshape(-1, 9)
    s_contrib = _mask_real_edges((n * dist)[:, None] * outer, offsets)
    raw = _segment_sum(s_contrib, bond_crystal, num_crystals)
    return forces, raw.reshape(-1, 3, 3)


def swiglu_act(g, activation: str):
    """The gate activation of the LM feed-forward: silu (SwiGLU) or the
    tanh form of gelu (GeGLU, ``jax.nn.gelu(approximate=True)``)."""
    if activation == "silu":
        return g * torch.sigmoid(g)
    if activation == "gelu":
        return F.gelu(g, approximate="tanh")
    raise ValueError(f"activation must be 'silu' or 'gelu', got "
                     f"{activation!r}")


def fused_swiglu_ref(x, w_gate, w_up, w_down, activation: str = "silu"):
    """LM gated MLP ``(act(x Wg) * (x Wu)) Wd``, (M, D) -> (M, D), with the
    rounding points of the fused kernel: g and u accumulate in f32, the
    activation runs in f32, h is rounded to ``x.dtype`` before the down
    product, which accumulates in f32 and rounds once."""
    f32 = torch.float32
    xf = x.to(f32)
    g = xf @ w_gate.to(f32)
    u = xf @ w_up.to(f32)
    h = (swiglu_act(g, activation) * u).to(x.dtype)
    return (h.to(f32) @ w_down.to(f32)).to(x.dtype)


def flash_attention_ref(q, k, v, *, causal: bool, scale=None):
    """(B, H, S, D) attention oracle (``repro.kernels.ref
    .flash_attention_ref``) with the flash kernel's causal convention: row
    i keeps columns j <= i counted from the top-left corner.  Logits in
    the operand dtype, masked to its ``finfo.min``, softmax in f32 cast
    back."""
    if scale is None:
        scale = 1.0 / torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        rows = torch.arange(s_q, device=q.device)[:, None]
        cols = torch.arange(s_k, device=q.device)[None, :]
        logits = torch.where(rows >= cols, logits,
                             torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
