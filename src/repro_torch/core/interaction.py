"""Interaction block: GatedMLP, AtomConv, BondConv, AngleUpdate.

PyTorch port of ``repro.core.interaction``.  Both block variants (paper
Eq. 10 vs Eq. 11):

  - ``reference``: BondConv consumes v^{t+1}; AngleUpdate consumes v^{t+1}
    and e^{t+1} (sequential dependency chain, as in CHGNet v0.3.0).
  - ``fast``: dependency elimination (FastCHGNet C2) — BondConv and
    AngleUpdate consume the layer-t features.

GatedMLP phi(x) = sigmoid(LN(x@Wg+bg)) * silu(LN(x@Wc+bc)), with its
parameters stored packed as in the JAX package (``w = [Wc ‖ Wg]`` of
shape (d_in, 2d), applied as ``x @ w + b``), so the weight bridge is a
copy.  ``conv_impl="fused"`` routes the whole message path of atom_conv /
bond_conv / sym_bond_conv to the hand-written kernels in
``repro_torch.kernels.ops``; on the unfused path ``mlp_impl="pallas"`` and
``agg_impl="pallas"`` route the GatedMLP and the segment sum to theirs.

``bond_store="undirected"`` (DESIGN.md §5) keeps the envelopes e^a / e^b
at the undirected rows (Eu), read through ``graph.bond_pair``;
``bond_features="undirected"`` (§10, the symmetric trunk) keeps e at Eu
and a at the angle-pair dedup rows (Au) too, with the symmetrized bond
conv and angle update below.

Precision (DESIGN.md §4), at the JAX package's cast boundaries: the
features arrive in the policy's compute dtype; parameters are cast to it
at their use sites (``linear_apply``, ``gated_mlp_apply``, the MLP trees
handed to the fused kernels); products accumulate in f32 and are cast
back to the operand dtype (``dot_accum``); LayerNorm statistics and every
segment sum are f32, cast back; masks are cast to the feature dtype, so
that a bf16 feature times an f32 mask stays bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import gather_rows
from .graph import CrystalGraphBatch


def _glorot(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    scale = math.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale


def linear_init(gen: torch.Generator, d_in: int, d_out: int) -> dict:
    return {"w": _glorot(gen, (d_in, d_out)),
            "b": torch.zeros((d_out,), dtype=torch.float32)}


def dot_accum(x, w):
    """x @ w with the products accumulated in f32 and the result cast back
    to x's dtype (DESIGN.md §4); for f32 operands exactly ``x @ w``.  On
    the card a bf16 product is cuBLAS's, which sums in f32 with
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    off (``chip_smoke.py`` turns it off); on the CPU the operands are
    widened and multiplied in f32."""
    if x.dtype == torch.float32 or x.is_cuda:
        return x @ w
    return (x.float() @ w.float()).to(x.dtype)


def linear_apply(p, x):
    # cast-to-compute view: the parameters are cast to the activation
    # dtype at the use site (no-op under f32)
    return dot_accum(x, p["w"].to(x.dtype)) + p["b"].to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    # population variance over the last axis, as jnp.var; statistics in
    # f32, the result cast back to x's dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# GatedMLP
# ---------------------------------------------------------------------------

def gated_mlp_init(gen: torch.Generator, d_in: int, d_out: int) -> dict:
    """Packed storage layout: each half glorot-initialized with its own
    fan-out, concatenated once here."""
    return {
        "w": torch.cat([_glorot(gen, (d_in, d_out)),
                        _glorot(gen, (d_in, d_out))], dim=1),
        "b": torch.zeros((2 * d_out,), dtype=torch.float32),
        "ln_scale": torch.ones((2 * d_out,), dtype=torch.float32),
        "ln_bias": torch.zeros((2 * d_out,), dtype=torch.float32),
    }


def gated_mlp_apply(p, x, impl: str = "packed"):
    d = p["w"].shape[1] // 2
    # cast-to-compute view (DESIGN.md §4)
    w, b = p["w"].to(x.dtype), p["b"].to(x.dtype)
    if impl == "ref":
        core = layer_norm(dot_accum(x, w[:, :d]) + b[:d],
                          p["ln_scale"][:d], p["ln_bias"][:d])
        gate = layer_norm(dot_accum(x, w[:, d:]) + b[d:],
                          p["ln_scale"][d:], p["ln_bias"][d:])
        return F.silu(core) * torch.sigmoid(gate)
    if impl == "packed":
        # one GEMM against the pre-packed weights, shared epilogue with
        # silu(x) = x * sigmoid(x)
        y = dot_accum(x, w) + b
        core = layer_norm(y[..., :d], p["ln_scale"][:d], p["ln_bias"][:d])
        gate = layer_norm(y[..., d:], p["ln_scale"][d:], p["ln_bias"][d:])
        return (core * torch.sigmoid(core)) * torch.sigmoid(gate)
    if impl == "pallas":
        from repro_torch.kernels import ops as kops

        return kops.fused_gated_mlp_packed(x, w, b, p["ln_scale"],
                                           p["ln_bias"])
    raise ValueError(f"unknown GatedMLP impl {impl!r}")


# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------

def segment_aggregate(values, segment_ids, num_segments, mask,
                      impl="scatter", *, offsets=None):
    """sum_{e : seg(e)=s} values[e] * mask[e]  -> (num_segments, D).

    impl="scatter": ``index_add_`` (the reference).
    impl="matmul" : one-hot matmul, O(E*S) flops, in plain torch (the JAX
        package runs it on the MXU outside any kernel).
    impl="sorted" : requires real ids sorted by segment (DESIGN.md §1);
        the padded tail is pointed at the last segment (its payload is
        masked to zero), as the JAX package does before its sorted
        segment sum.  Same sum as "scatter".
    impl="pallas" : the sorted-segment kernel
        (``kernels.ops.fused_segment_sum``); needs the CSR ``offsets``.

    Every impl accumulates in f32 and casts the sum back to the operand
    dtype (DESIGN.md §4).
    """
    v = values * mask[..., None].to(values.dtype)
    if impl == "matmul":
        onehot = F.one_hot(segment_ids.long(), num_segments).float()
        return torch.einsum("es,ed->sd", onehot, v.float()).to(v.dtype)
    if impl == "pallas":
        if offsets is None:
            raise ValueError(
                'impl="pallas" needs CSR offsets (sorted-segment layout); '
                "pack batches through repro_torch.batching to get them")
        from repro_torch.kernels import ops as kops

        return kops.fused_segment_sum(v, segment_ids, offsets, num_segments)
    if impl == "sorted":
        segment_ids = torch.where(mask > 0, segment_ids.long(),
                                  num_segments - 1)
    elif impl != "scatter":
        raise ValueError(f"unknown aggregate impl {impl!r}")
    out = v.new_zeros((num_segments,) + tuple(v.shape[1:]),
                      dtype=torch.float32)
    return out.index_add_(0, segment_ids.long(), v.float()).to(v.dtype)


# ---------------------------------------------------------------------------
# Interaction block
# ---------------------------------------------------------------------------

def interaction_block_init(gen: torch.Generator, dim: int = 64) -> dict:
    return {
        "atom_mlp": gated_mlp_init(gen, 3 * dim, dim),
        "atom_out": linear_init(gen, dim, dim),
        "bond_mlp": gated_mlp_init(gen, 4 * dim, dim),
        "bond_out": linear_init(gen, dim, dim),
        "angle_mlp": gated_mlp_init(gen, 4 * dim, dim),
    }


def atom_conv(p, graph: CrystalGraphBatch, v, e, e_a, *, mlp_impl, agg_impl,
              conv_impl: str = "unfused", bond_store: str = "directed",
              bond_features: str = "directed"):
    """Eq. 4: v_i <- v_i + L_v[ sum_j e^a_ij * phi(v_i, v_j, e_ij) ].

    ``conv_impl="fused"`` runs the message path (gather -> GatedMLP ->
    envelope -> reduce) as one kernel over the sorted CSR rows (DESIGN.md
    §3); ``mlp_impl``/``agg_impl`` are then subsumed.  The undirected
    store reads ``e_a`` (and, with ``bond_features="undirected"``, ``e``)
    at Eu rows through ``bond_pair``: the envelope is a function of |r_ij|
    and e_ij == e_ji in the symmetric trunk, so no sign is applied.
    """
    mirror = bond_store == "undirected"
    und = bond_features == "undirected"
    if conv_impl == "fused":
        from repro_torch.kernels import ops as kops

        # the kernel's operands share the features' dtype (DESIGN.md §4)
        mlp = {k: t.to(v.dtype) for k, t in p["atom_mlp"].items()}
        agg = kops.fused_atom_conv(
            v, e, e_a, mlp["w"], mlp["b"], mlp["ln_scale"], mlp["ln_bias"],
            graph.bond_center, graph.bond_nbr, graph.bond_offsets,
            pair=graph.bond_pair if mirror else None, und_features=und,
        )
    elif conv_impl == "unfused":
        e_dir = gather_rows(e, graph.bond_pair) if und else e
        f_v = torch.cat([gather_rows(v, graph.bond_center),
                         gather_rows(v, graph.bond_nbr), e_dir], dim=-1)
        env = gather_rows(e_a, graph.bond_pair) if mirror else e_a
        msg = gated_mlp_apply(p["atom_mlp"], f_v, mlp_impl) * env
        agg = segment_aggregate(
            msg, graph.bond_center, graph.atom_cap, graph.bond_mask, agg_impl,
            offsets=graph.bond_offsets)
    else:
        raise ValueError(f"unknown conv impl {conv_impl!r}")
    mask = graph.atom_mask[..., None].to(v.dtype)
    return v + linear_apply(p["atom_out"], agg) * mask


def bond_conv(p, graph: CrystalGraphBatch, v_in, e, a, e_b, *, mlp_impl,
              agg_impl, conv_impl: str = "unfused",
              bond_store: str = "directed"):
    """Eq. 5: e_ij <- e_ij + L_e[ sum_k e^b_ij * e^b_ik * phi(f_e) ].

    ``v_in`` is v^{t+1} in the reference variant, v^t in the fast variant.
    The undirected store reads both envelope factors at Eu rows through
    ``bond_pair[angle_*]``.
    """
    center = graph.bond_center[graph.angle_ij]
    mirror = bond_store == "undirected"
    if conv_impl == "fused":
        from repro_torch.kernels import ops as kops

        mlp = {k: t.to(e.dtype) for k, t in p["bond_mlp"].items()}
        agg = kops.fused_bond_conv(
            v_in, e, a, e_b, mlp["w"], mlp["b"], mlp["ln_scale"],
            mlp["ln_bias"], graph.angle_ij, graph.angle_ik, center,
            graph.angle_offsets, pair=graph.bond_pair if mirror else None,
        )
    elif conv_impl == "unfused":
        f_e = torch.cat(
            [gather_rows(v_in, center), gather_rows(e, graph.angle_ij),
             gather_rows(e, graph.angle_ik), a], dim=-1)
        msg = gated_mlp_apply(p["bond_mlp"], f_e, mlp_impl)
        env_ij, env_ik = graph.angle_ij, graph.angle_ik
        if mirror:
            env_ij = graph.bond_pair[env_ij.long()]
            env_ik = graph.bond_pair[env_ik.long()]
        msg = msg * gather_rows(e_b, env_ij) * gather_rows(e_b, env_ik)
        agg = segment_aggregate(
            msg, graph.angle_ij, graph.bond_cap, graph.angle_mask, agg_impl,
            offsets=graph.angle_offsets)
    else:
        raise ValueError(f"unknown conv impl {conv_impl!r}")
    mask = graph.bond_mask[..., None].to(e.dtype)
    return e + linear_apply(p["bond_out"], agg) * mask


def angle_update(p, graph: CrystalGraphBatch, v_in, e_in, a, *, mlp_impl):
    """Eq. 6: a_ijk <- a_ijk + phi_a(f_a).

    Reference: f_a = [v^{t+1}, e^{t+1}, a^t]; fast: f_a = [v^t, e^t, a^t].
    """
    center = graph.bond_center[graph.angle_ij]
    f_a = torch.cat(
        [gather_rows(v_in, center), gather_rows(e_in, graph.angle_ij),
         gather_rows(e_in, graph.angle_ik), a], dim=-1)
    upd = gated_mlp_apply(p["angle_mlp"], f_a, mlp_impl)
    return a + upd * graph.angle_mask[..., None].to(a.dtype)


# ---------------------------------------------------------------------------
# Symmetric half-graph trunk (DESIGN.md §10, bond_features="undirected")
# ---------------------------------------------------------------------------

def _sym_ids(graph: CrystalGraphBatch):
    """Per dedup angle row: its center atom and the undirected ids of its
    two bonds."""
    ij, ik = graph.und_angle_ij.long(), graph.und_angle_ik.long()
    return graph.bond_center[ij], graph.bond_pair[ij], graph.bond_pair[ik]


def _sym_inputs(graph: CrystalGraphBatch, v_in, e_in, a_u):
    """Swap-symmetrized f over Au rows: [v_center, e_s, e_s, a_u].

    e_s = e[du1] + e[du2] is invariant under swapping the pair's two
    bonds, so both directed orientations of a dedup angle give the same
    row and one GatedMLP evaluation stands in for both.  The width is the
    directed f = [v, e_ij, e_ik, a]'s, so the parameters are shared.
    """
    ctr, du1, du2 = _sym_ids(graph)
    e_s = gather_rows(e_in, du1) + gather_rows(e_in, du2)
    f = torch.cat([gather_rows(v_in, ctr), e_s, e_s, a_u], dim=-1)
    return f, du1, du2


def sym_bond_conv(p, graph: CrystalGraphBatch, v_in, e, a_u, e_b, *,
                  mlp_impl, agg_impl, conv_impl: str = "unfused"):
    """Symmetrized Eq. 5 over Eu rows (DESIGN.md §10).

    ``e`` / ``e_b`` live at Eu, ``a_u`` at Au.  One message per real dedup
    angle, phi([v_ctr, e_s, e_s, a_u]) * e^b[du1] * e^b[du2], goes to both
    undirected bonds of its pair through the dest-sorted incidence store
    (``sym_dest`` / ``sym_rep`` / ``sym_offsets``).  ``conv_impl="fused"``
    runs ``kernels.ops.fused_sym_bond_conv`` (two kernels).
    """
    if conv_impl == "fused":
        from repro_torch.kernels import ops as kops

        mlp = {k: t.to(e.dtype) for k, t in p["bond_mlp"].items()}
        ctr, du1, du2 = _sym_ids(graph)
        agg = kops.fused_sym_bond_conv(
            v_in, e, a_u, e_b, mlp["w"], mlp["b"], mlp["ln_scale"],
            mlp["ln_bias"], ctr, du1, du2, graph.sym_rep, graph.sym_dest,
            graph.sym_offsets)
    elif conv_impl == "unfused":
        f, du1, du2 = _sym_inputs(graph, v_in, e, a_u)
        msg = gated_mlp_apply(p["bond_mlp"], f, mlp_impl)
        msg = msg * gather_rows(e_b, du1) * gather_rows(e_b, du2)
        # incidences are valid by position: the padded ones carry rep 0,
        # a real Au row, so und_angle_mask[sym_rep] would let them through
        incid_mask = (torch.arange(graph.angle_cap, device=e.device)
                      < graph.sym_offsets[-1]).to(e.dtype)
        agg = segment_aggregate(
            gather_rows(msg, graph.sym_rep), graph.sym_dest, graph.und_cap,
            incid_mask, agg_impl, offsets=graph.sym_offsets)
    else:
        raise ValueError(f"unknown conv impl {conv_impl!r}")
    mask = graph.und_mask[..., None].to(e.dtype)
    return e + linear_apply(p["bond_out"], agg) * mask


def sym_angle_update(p, graph: CrystalGraphBatch, v_in, e_in, a_u, *,
                     mlp_impl):
    """Symmetrized Eq. 6 at Au rows (DESIGN.md §10): one update per dedup
    angle stands in for both directed orientations.  ``e_in`` is the
    Eu-resident bond table."""
    f_a, _, _ = _sym_inputs(graph, v_in, e_in, a_u)
    upd = gated_mlp_apply(p["angle_mlp"], f_a, mlp_impl)
    return a_u + upd * graph.und_angle_mask[..., None].to(a_u.dtype)


def interaction_block_apply(
    p,
    graph: CrystalGraphBatch,
    v,
    e,
    a,
    e_a,
    e_b,
    *,
    variant: str = "fast",
    mlp_impl: str = "packed",
    agg_impl: str = "scatter",
    conv_impl: str = "unfused",
    bond_store: str = "directed",
    bond_features: str = "directed",
):
    """One interaction block IB^t (paper Eq. 3), either variant.

    ``bond_features="undirected"`` (DESIGN.md §10) takes the symmetric
    trunk's updates: ``e`` is Eu-resident, ``a`` Au-resident.
    """
    sym = bond_features == "undirected"
    v_new = atom_conv(p, graph, v, e, e_a, mlp_impl=mlp_impl,
                      agg_impl=agg_impl, conv_impl=conv_impl,
                      bond_store=bond_store, bond_features=bond_features)

    def _bond(v_in):
        if sym:
            return sym_bond_conv(p, graph, v_in, e, a, e_b,
                                 mlp_impl=mlp_impl, agg_impl=agg_impl,
                                 conv_impl=conv_impl)
        return bond_conv(p, graph, v_in, e, a, e_b, mlp_impl=mlp_impl,
                         agg_impl=agg_impl, conv_impl=conv_impl,
                         bond_store=bond_store)

    def _angle(v_in, e_in):
        if sym:
            return sym_angle_update(p, graph, v_in, e_in, a,
                                    mlp_impl=mlp_impl)
        return angle_update(p, graph, v_in, e_in, a, mlp_impl=mlp_impl)

    if variant == "reference":
        e_new = _bond(v_new)
        a_new = _angle(v_new, e_new)
    elif variant == "fast":
        # dependency elimination (Eq. 11): all three read layer-t features
        e_new = _bond(v)
        a_new = _angle(v, e)
    else:
        raise ValueError(f"unknown block variant {variant!r}")
    return v_new, e_new, a_new
