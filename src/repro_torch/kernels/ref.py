"""Plain PyTorch versions of the hand-written kernels (ground truth).

Mirrors ``repro.kernels.ref`` function for function.  The op wrappers in
``repro_torch.kernels.ops`` run these on CPU tensors; on the card they
are the yardstick the CUDA kernels are held against.  The reductions use
``index_add_``, which on CUDA uses atomics: fine for a yardstick of
correctness, never used by a kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _layer_norm(x, scale, bias, eps=1e-5):
    # population variance (jnp.var), statistics in f32
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def gated_mlp_packed_ref(x, w, b, ln_scale, ln_bias):
    """Packed-parameter GatedMLP: w = [Wc ‖ Wg], b/ln_* = [core ‖ gate]."""
    d = w.shape[1] // 2
    y = x @ w + b
    core = _layer_norm(y[..., :d], ln_scale[:d], ln_bias[:d])
    gate = _layer_norm(y[..., d:], ln_scale[d:], ln_bias[d:])
    return F.silu(core) * torch.sigmoid(gate)


def _mask_real_edges(msg, offsets):
    """Zero everything past offsets[-1] (the real-edge count, DESIGN.md §1)."""
    valid = torch.arange(msg.shape[0], device=msg.device) < offsets[-1]
    return torch.where(valid[:, None], msg, torch.zeros((), dtype=msg.dtype,
                                                        device=msg.device))


def _segment_sum(values, ids, num_segments):
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add_(0, ids.long(), values)


def fused_atom_conv_ref(v, e, e_a, w, b, ln_scale, ln_bias,
                        bond_center, bond_nbr, offsets):
    """Unfused Eq. 4 message path: gather-concat -> GatedMLP -> envelope ->
    segment reduce -> (A, D)."""
    x = torch.cat([v[bond_center], v[bond_nbr], e], dim=-1)
    msg = gated_mlp_packed_ref(x, w, b, ln_scale, ln_bias) * e_a
    msg = _mask_real_edges(msg, offsets)
    return _segment_sum(msg, bond_center, v.shape[0])


def fused_bond_conv_ref(v, e, a, e_b, w, b, ln_scale, ln_bias,
                        angle_ij, angle_ik, center_ids, offsets):
    """Unfused Eq. 5 message path -> (E, D) (``center_ids =
    bond_center[angle_ij]``, precomputed by the caller)."""
    x = torch.cat([v[center_ids], e[angle_ij], e[angle_ik], a], dim=-1)
    msg = gated_mlp_packed_ref(x, w, b, ln_scale, ln_bias)
    msg = msg * e_b[angle_ij] * e_b[angle_ik]
    msg = _mask_real_edges(msg, offsets)
    return _segment_sum(msg, angle_ij, e.shape[0])


def fused_force_readout_ref(e, x_hat, w1, b1, w2, b2, bond_center, offsets,
                            num_atoms):
    """Unfused Eq. 7: per-bond scalar MLP -> n_ij * x_hat_ij -> atom reduce."""
    h = F.silu(e @ w1 + b1)
    n = (h @ w2 + b2)[..., 0]
    contrib = _mask_real_edges(n[:, None] * x_hat, offsets)
    return _segment_sum(contrib, bond_center, num_atoms)
