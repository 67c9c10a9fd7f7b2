"""Radial / angular basis expansion (paper §II-B (2), §III-C).

PyTorch port of ``repro.core.basis``:

  - ``envelope_reference``  : Eq. 12 (4 independent pow() terms)
  - ``envelope_factored``   : Eq. 13 in Horner form (single pow + 2 fma)
  - ``smooth_rbf``          : trainable-frequency smooth radial Bessel basis
  - ``fourier_basis``       : angle Fourier expansion [DC, cos(n t), sin(n t)]
  - ``compute_geometry``    : bond vectors / distances / angle cosines of a
                              padded batch;
  - ``compute_geometry_undirected`` : the same once per undirected pair
                              (DESIGN.md §5), the angles optionally at the
                              angle-pair dedup rows.

Geometry and every basis expansion stay f32 (DESIGN.md §4).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from .graph import CrystalGraphBatch


def envelope_reference(xi: torch.Tensor, p: int = 8) -> torch.Tensor:
    """Eq. 12 with the corrected smooth-cutoff coefficients
    a=-(p+1)(p+2)/2, b=p(p+2), c=-p(p+1)/2, so u(1) = u'(1) = 0."""
    a = -(p + 1) * (p + 2) / 2.0
    b = float(p * (p + 2))
    c = -p * (p + 1) / 2.0
    return 1.0 + a * ref.integer_pow(xi, p) + b * ref.integer_pow(xi, p + 1) \
        + c * ref.integer_pow(xi, p + 2)


def envelope_factored(xi: torch.Tensor, p: int = 8) -> torch.Tensor:
    """Eq. 13: u = 1 - xi^p/2 * [(p+1)(p+2) - 2p(p+2) xi + p(p+1) xi^2]."""
    return ref.envelope(xi, p)


def rbf_frequencies(num_basis: int) -> torch.Tensor:
    """Initial (trainable) frequencies n*pi, n = 1..num_basis."""
    return torch.arange(1, num_basis + 1, dtype=torch.float32) * math.pi


def smooth_rbf(
    r: torch.Tensor,
    freqs: torch.Tensor,
    r_cut: float,
    p: int = 8,
    *,
    envelope=envelope_factored,
) -> torch.Tensor:
    """sRBF(r)_n = sqrt(2/rc) * sin(f_n * r/rc) / r * u(r/rc).

    r: (...,) distances;  freqs: (K,) trainable;  returns (..., K).
    Safe at r ~ 0 (padded entries) through the ``r_safe`` guard.
    """
    r = r.float()
    freqs = freqs.float()
    xi = r / r_cut
    u = envelope(xi, p)
    r_safe = torch.where(r > 1e-8, r, torch.ones_like(r))
    phases = xi[..., None] * freqs
    val = math.sqrt(2.0 / r_cut) * torch.sin(phases) / r_safe[..., None]
    return val * u[..., None]


def fourier_basis(theta: torch.Tensor, num_basis: int = 31) -> torch.Tensor:
    """FT(theta) -> (..., num_basis): [1/sqrt(2), cos(n t), sin(n t)]/sqrt(pi).

    num_basis = 2*L + 1 (DC + L cos + L sin). Paper sets num_basis = 31.
    """
    if num_basis % 2 != 1:
        raise ValueError("fourier num_basis must be odd (DC + pairs)")
    flat = ref.fused_fourier_ref(theta.float().reshape(-1), num_basis)
    return flat.reshape(theta.shape + (num_basis,))


def _rows(table, ids):
    """``table[ids]`` over the first axis through ``ref.gather_rows``: the
    autodiff readout differentiates these gathers, and indexing's CUDA
    backward sums the ~300k padded rows that share id 0 in one warp."""
    flat = ref.gather_rows(table.reshape(table.shape[0], -1), ids)
    return flat.reshape((ids.shape[0],) + tuple(table.shape[1:]))


def _cart_positions(graph: CrystalGraphBatch, displacement, strain):
    """Strained lattice + Cartesian positions."""
    lattice = graph.lattice
    if strain is not None:
        eye = torch.eye(3, dtype=lattice.dtype, device=lattice.device)
        lattice = torch.einsum("bij,bjk->bik", lattice, eye + strain)
    cart = torch.einsum(
        "ai,aij->aj", graph.frac_coords, _rows(lattice, graph.atom_crystal))
    if displacement is not None:
        cart = cart + displacement
    return cart, lattice


def _bond_vectors(cart, lattice, center, nbr, image, crystal):
    """r_ij = r_j + image @ L - r_i and its length."""
    shift = torch.einsum("bi,bij->bj", image, _rows(lattice, crystal))
    vec = _rows(cart, nbr) + shift - _rows(cart, center)
    dist = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-16)
    return vec, dist


def _angle_cosines(vec, dist, idx_ij, idx_ik):
    """Angle cosines (clipped to ±(1 - 1e-7)) and angles between the bonds
    selected by two index arrays."""
    v_ij = _rows(vec, idx_ij)
    v_ik = _rows(vec, idx_ik)
    d_ij = _rows(dist, idx_ij)
    d_ik = _rows(dist, idx_ik)
    cos_t = torch.sum(v_ij * v_ik, dim=-1) / (d_ij * d_ik + 1e-12)
    cos_t = torch.clamp(cos_t, -1.0 + 1e-7, 1.0 - 1e-7)
    return cos_t, torch.arccos(cos_t)


def compute_geometry(
    graph: CrystalGraphBatch,
    *,
    displacement: torch.Tensor | None = None,
    strain: torch.Tensor | None = None,
):
    """Bond vectors, distances and angle cosines for a padded batch.

    displacement: (atom_cap, 3) added to Cartesian coordinates.
    strain: (B, 3, 3); the lattice is deformed as L' = L @ (I + eps).

    Returns (bond_vec (Nb,3), bond_dist (Nb,), cos_theta (Na,), theta (Na,)).
    """
    cart, lattice = _cart_positions(graph, displacement, strain)
    vec, dist = _bond_vectors(
        cart, lattice, graph.bond_center, graph.bond_nbr, graph.bond_image,
        graph.bond_crystal,
    )
    cos_t, theta = _angle_cosines(vec, dist, graph.angle_ij, graph.angle_ik)
    return vec, dist, cos_t, theta


def compute_geometry_undirected(
    graph: CrystalGraphBatch,
    *,
    displacement: torch.Tensor | None = None,
    strain: torch.Tensor | None = None,
    angle_rows: str = "directed",
):
    """Geometry on the undirected half-graph store (DESIGN.md §5).

    Bond vectors and lengths are computed once per undirected pair; the
    directed views go through the mirror maps,
    ``vec = bond_sign * vec_und[bond_pair]`` and
    ``dist = dist_und[bond_pair]`` (padded bonds carry sign 0 and pair 0).
    ``angle_rows="undirected"`` takes the angle cosines at the angle-pair
    dedup rows (``und_angle_ij`` / ``und_angle_ik``, Au rows), where the
    swap-symmetric cosine equals both directed rows it stands for;
    ``"directed"`` at the ordered angle list.

    Returns (vec_und (Eu,3), dist_und (Eu,), vec (Nb,3), dist (Nb,),
    cos_theta, theta), the angle outputs at Na or Au rows.
    """
    cart, lattice = _cart_positions(graph, displacement, strain)
    vec_und, dist_und = _bond_vectors(
        cart, lattice, graph.und_center, graph.und_nbr, graph.und_image,
        graph.und_crystal,
    )
    vec = graph.bond_sign[..., None] * _rows(vec_und, graph.bond_pair)
    dist = _rows(dist_und, graph.bond_pair)
    if angle_rows == "undirected":
        ij, ik = graph.und_angle_ij, graph.und_angle_ik
    elif angle_rows == "directed":
        ij, ik = graph.angle_ij, graph.angle_ik
    else:
        raise ValueError(f"unknown angle_rows {angle_rows!r}")
    cos_t, theta = _angle_cosines(vec, dist, ij, ik)
    return vec_und, dist_und, vec, dist, cos_t, theta
