"""Output heads (paper §III-B, Fig. 2c/2d), PyTorch port of
``repro.core.heads``.

  Force head (Eq. 7):  n_ij = MLP(e_ij) in R;  F_i = sum_j n_ij * x_hat_ij
  Stress head (Eq. 9): sigma = sum_i (scale * MLP9(v_i)) ⊙ N(L),
      N(L) = sum_{a,b} L_a/|L_a| ⊗ L_b/|L_b|  (3x3 lattice-normal matrix).
  Bond-virial stress (DESIGN.md §7): sigma = (1/2V) sum_ij n_ij d_ij
      x_hat_ij ⊗ x_hat_ij, from the force head's own n_ij (no parameters).

Precision (DESIGN.md §4): the head MLPs run at the features' (compute)
dtype; the per-crystal energy and stress reductions, the stress head's
lattice normals and the bond virial are pinned to f32, and
``chgnet_apply`` casts every output to the policy's ``output_dtype``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import scatter_rows
from .graph import CrystalGraphBatch
from .interaction import linear_apply, linear_init, segment_aggregate

EV_A3_TO_GPA = 160.21766  # eV/A^3 -> GPa

# one epsilon for every unit-vector normalization in the model, shared by
# the heads and the kernel wrappers
_UNIT_EPS = 1e-12


def bond_unit_vectors(bond_vec, bond_dist, dtype=None):
    """x_hat = vec / (dist + eps), the one shared normalization.  The
    geometry is f32; ``dtype`` (the bond features' compute dtype) is the
    cast boundary after the f32 division."""
    x_hat = bond_vec / (bond_dist[..., None] + _UNIT_EPS)
    return x_hat if dtype is None else x_hat.to(dtype)


def mlp_init(gen: torch.Generator, dims) -> list:
    return [linear_init(gen, a, b) for a, b in zip(dims[:-1], dims[1:])]


def mlp_apply(layers, x):
    for i, p in enumerate(layers):
        x = linear_apply(p, x)
        if i < len(layers) - 1:
            x = F.silu(x)
    return x


def _per_crystal_sum(values, graph: CrystalGraphBatch):
    out = values.new_zeros((graph.num_crystals,) + tuple(values.shape[1:]))
    return out.index_add_(0, graph.atom_crystal.long(), values)


# ------------------------------ energy ------------------------------------

def energy_head_init(gen: torch.Generator, dim: int = 64) -> dict:
    return {"mlp": mlp_init(gen, (dim, dim, dim, 1))}


def energy_head_apply(p, graph: CrystalGraphBatch, v):
    """Per-site energies summed per crystal -> (B,) total energies [eV],
    the sum in f32."""
    site_e = mlp_apply(p["mlp"], v)[..., 0].float() * graph.atom_mask
    return _per_crystal_sum(site_e, graph)


# ------------------------------ magmom ------------------------------------

def magmom_head_init(gen: torch.Generator, dim: int = 64) -> dict:
    return {"mlp": mlp_init(gen, (dim, dim, 1))}


def magmom_head_apply(p, graph: CrystalGraphBatch, v):
    out = torch.abs(mlp_apply(p["mlp"], v)[..., 0])
    return out * graph.atom_mask.to(out.dtype)


# ------------------------------ force head --------------------------------

def force_head_init(gen: torch.Generator, dim: int = 64) -> dict:
    return {"mlp": mlp_init(gen, (dim, dim, 1))}


def force_head_apply(p, graph: CrystalGraphBatch, e, bond_vec, bond_dist,
                     *, agg_impl: str = "scatter",
                     conv_impl: str = "unfused"):
    """Eq. 7: F_i = sum_j n_ij * x_hat_ij (rotation equivariant).

    With ``conv_impl="fused"`` the whole readout (scalar MLP -> x_hat
    weighting -> reduce) is one kernel over the sorted CSR rows.  x_hat
    and the head's weights take e's (compute) dtype.
    """
    x_hat = bond_unit_vectors(bond_vec, bond_dist, e.dtype)
    if conv_impl == "fused":
        from repro_torch.kernels import ops as kops

        l0, l1 = p["mlp"]  # force head is fixed at (dim -> dim -> 1)
        cd = e.dtype
        out = kops.fused_force_readout(
            e, x_hat, l0["w"].to(cd), l0["b"].to(cd), l1["w"].to(cd),
            l1["b"].to(cd), graph.bond_center, graph.bond_offsets,
            graph.atom_cap,
        )
        return out * graph.atom_mask[..., None].to(out.dtype)
    n_ij = mlp_apply(p["mlp"], e)[..., 0]  # (Nb,); masked by the aggregate
    contrib = n_ij[..., None] * x_hat
    out = segment_aggregate(
        contrib, graph.bond_center, graph.atom_cap, graph.bond_mask, agg_impl,
        offsets=graph.bond_offsets)
    return out * graph.atom_mask[..., None].to(out.dtype)


# ------------------------------ stress head -------------------------------

def stress_head_init(gen: torch.Generator, dim: int = 64,
                     scale: float = 0.1) -> dict:
    return {"mlp": mlp_init(gen, (dim, dim, 9)),
            "scale": torch.tensor(scale, dtype=torch.float32)}


def stress_head_apply(p, graph: CrystalGraphBatch, v):
    """Eq. 9. Returns (B, 3, 3) stresses [GPa]; the lattice normals and the
    per-crystal sum in f32."""
    lat = graph.lattice  # (B, 3, 3) rows are lattice vectors
    l_hat = lat / (torch.linalg.norm(lat, dim=-1, keepdim=True) + 1e-12)
    s = torch.sum(l_hat, dim=1)  # (B, 3)
    normal = torch.einsum("bm,bn->bmn", s, s)
    per_atom = mlp_apply(p["mlp"], v).float() \
        * graph.atom_mask[..., None]  # (A, 9)
    per_crystal = _per_crystal_sum(per_atom, graph).reshape(-1, 3, 3)
    return p["scale"].float() * per_crystal * normal


# ------------------------- bond-virial stress ------------------------------

def _per_crystal_aggregate(values, ids, num_crystals, mask, agg_impl):
    """Bond -> crystal reduction through ``segment_aggregate``.

    ``ids`` are sorted over the real prefix (crystals pack in sequence and
    bonds sort by center), so the "sorted" tier applies; ``"pallas"`` maps
    to it, as in the JAX package: the crystal axis is a few rows long and
    has no CSR offsets of its own.
    """
    impl = "sorted" if agg_impl == "pallas" else agg_impl
    return segment_aggregate(values, ids, num_crystals, mask, impl)


def _virial_raw_to_gpa(raw, graph: CrystalGraphBatch):
    """(B, 3, 3) sums of n d x_hat⊗x_hat -> stress [GPa].

    sigma = raw * EV_A3_TO_GPA / (2V), V = |det lattice|; padded crystal
    slots (identity lattices) are masked to zero.
    """
    vol = torch.abs(torch.linalg.det(graph.lattice.float()))
    scale = EV_A3_TO_GPA / (2.0 * vol + _UNIT_EPS) * graph.crystal_mask
    return raw.float() * scale[:, None, None]


def force_virial_head_apply(p, graph: CrystalGraphBatch, e, bond_vec,
                            bond_dist, *, vec_und=None, dist_und=None,
                            agg_impl: str = "scatter",
                            conv_impl: str = "unfused",
                            bond_store: str = "directed"):
    """Force + bond-virial stress from one set of per-bond scalars.

    Returns ``(forces (A, 3), stress (B, 3, 3) [GPa, f32])`` with
    n_ij = MLP(e_ij):

        F_i   = sum_j n_ij x_hat_ij                          (Eq. 7)
        sigma = (1/2V) sum_ij n_ij d_ij x_hat_ij ⊗ x_hat_ij  [* GPa]

    The stress has no parameters of its own, so it is symmetric and
    rotates as R sigma R^T by construction.  ``conv_impl="fused"`` runs
    both in ``kernels.ops.fused_force_virial_readout`` (it reads the
    directed ``e``, whatever the store); the unfused path is the same math
    through ``segment_aggregate``.  With ``bond_store="undirected"``
    (DESIGN.md §5) the unfused path takes the outer products once per
    undirected pair from ``vec_und`` / ``dist_und`` (x_hat⊗x_hat does not
    depend on the bond's sign): the directed n d weights are summed onto
    the Eu rows through ``bond_pair`` first, in a fixed order
    (``kernels.ref.scatter_rows``: ``bond_pair`` is not sorted).  The
    virial is f32 from the per-bond weights on (DESIGN.md §4).
    """
    x_hat = bond_unit_vectors(bond_vec, bond_dist, e.dtype)
    if conv_impl == "fused":
        from repro_torch.kernels import ops as kops

        l0, l1 = p["mlp"]  # force head is fixed at (dim -> dim -> 1)
        cd = e.dtype
        forces, raw = kops.fused_force_virial_readout(
            e, x_hat, bond_dist, l0["w"].to(cd), l0["b"].to(cd),
            l1["w"].to(cd), l1["b"].to(cd),
            graph.bond_center, graph.bond_crystal, graph.bond_offsets,
            graph.atom_cap, graph.num_crystals)
        forces = forces * graph.atom_mask[..., None].to(forces.dtype)
        return forces, _virial_raw_to_gpa(raw, graph)

    n_ij = mlp_apply(p["mlp"], e)[..., 0]  # (Nb,); masked by the aggregate
    contrib = n_ij[..., None] * x_hat
    forces = segment_aggregate(
        contrib, graph.bond_center, graph.atom_cap, graph.bond_mask, agg_impl,
        offsets=graph.bond_offsets)
    forces = forces * graph.atom_mask[..., None].to(forces.dtype)
    w = n_ij.float() * bond_dist.float() * graph.bond_mask
    if bond_store == "undirected":
        w_u = scatter_rows(w[:, None], graph.bond_pair, graph.und_cap)
        xh_u = bond_unit_vectors(vec_und.float(), dist_und.float())
        outer = (xh_u[:, :, None] * xh_u[:, None, :]).reshape(-1, 9)
        raw = _per_crystal_aggregate(w_u * outer, graph.und_crystal,
                                     graph.num_crystals, graph.und_mask,
                                     agg_impl)
    elif bond_store == "directed":
        xh32 = x_hat.float()
        outer = (xh32[:, :, None] * xh32[:, None, :]).reshape(-1, 9)
        raw = _per_crystal_aggregate(w[:, None] * outer, graph.bond_crystal,
                                     graph.num_crystals, graph.bond_mask,
                                     agg_impl)
    else:
        raise ValueError(f"unknown bond store {bond_store!r}")
    return forces, _virial_raw_to_gpa(raw.reshape(-1, 3, 3), graph)
