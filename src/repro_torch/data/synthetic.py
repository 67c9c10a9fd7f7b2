"""Synthetic MPtrj-like dataset (offline stand-in for the licensed MPtrj).

A copy of ``repro.data.synthetic``: random structures whose size follows
a long-tailed lognormal (paper Fig. 5), labelled with a smooth analytic
potential,

    E = sum_{i<j} Morse(r_ij) + sum_z mu_z             (pair + element offset)
    F_i = -dE/dr_i                  (exact analytic derivative)
    sigma = (1/V) sum_bonds phi'(r)/r * (r_vec ⊗ r_vec)   (exact virial)
    m_i = softplus(rho_i) * w_{z_i}                    (smooth "magmom")

in plain numpy, so the same seed gives the JAX package's labels bit for
bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.neighbors import Crystal, GraphIndices, build_graph

# Morse parameters (eV, 1/A, A)
_DE, _A, _R0 = 0.5, 1.3, 2.6
EV_A3_TO_GPA = 160.21766


def _morse(r):
    e = np.exp(-_A * (r - _R0))
    return _DE * (e * e - 2.0 * e)


def _morse_dr(r):
    e = np.exp(-_A * (r - _R0))
    return _DE * (-2.0 * _A * e * e + 2.0 * _A * e)


@dataclasses.dataclass
class SyntheticConfig:
    num_crystals: int = 256
    min_atoms: int = 2
    max_atoms: int = 64
    lognormal_mu: float = 2.2     # matches MPtrj long tail (Fig. 5)
    lognormal_sigma: float = 0.7
    vol_per_atom: float = 14.0    # A^3
    num_elements: int = 89
    r_cut_atom: float = 6.0
    r_cut_bond: float = 3.0
    seed: int = 0


def generate_crystal(rng: np.random.Generator, cfg: SyntheticConfig) -> Crystal:
    n = int(np.clip(rng.lognormal(cfg.lognormal_mu, cfg.lognormal_sigma),
                    cfg.min_atoms, cfg.max_atoms))
    a = (n * cfg.vol_per_atom) ** (1.0 / 3.0)
    lat = np.eye(3) * a + rng.normal(0.0, 0.03 * a, (3, 3))
    frac = rng.random((n, 3))
    z = rng.integers(1, cfg.num_elements + 1, n)
    return Crystal(lattice=lat, frac_coords=frac, atomic_numbers=z)


def label_crystal(crystal: Crystal, graph: GraphIndices,
                  element_offsets: np.ndarray,
                  magmom_weights: np.ndarray) -> None:
    """Attach analytic labels in place (exact E/F/sigma consistency)."""
    lat = crystal.lattice
    cart = crystal.cart_coords()
    i = graph.bond_center
    j = graph.bond_nbr
    shift = graph.bond_image.astype(np.float64) @ lat
    vec = cart[j] + shift - cart[i]          # (Nb, 3) r_ij = r_j - r_i
    dist = np.linalg.norm(vec, axis=-1)
    n = crystal.num_atoms

    # energy: directed bonds double-count pairs -> 0.5 factor
    e_pair = 0.5 * np.sum(_morse(dist))
    e_off = float(np.sum(element_offsets[crystal.atomic_numbers]))
    crystal.energy = float(e_pair + e_off)

    # forces: F_i = sum_j phi'(r_ij) * (r_j - r_i)/r_ij
    dphi = _morse_dr(dist)
    f = np.zeros((n, 3))
    np.add.at(f, i, dphi[:, None] * vec / dist[:, None])
    crystal.forces = f

    # virial stress: sigma = (1/2V) sum_directed phi'(r)/r * (vec ⊗ vec)
    vol = abs(np.linalg.det(lat))
    outer = vec[:, :, None] * vec[:, None, :]
    sigma = 0.5 * np.sum((dphi / dist)[:, None, None] * outer, axis=0) / vol
    crystal.stress = sigma * EV_A3_TO_GPA

    # magmom: smooth function of local density rho_i = sum_j exp(-r_ij)
    rho = np.zeros(n)
    np.add.at(rho, i, np.exp(-dist))
    w = magmom_weights[crystal.atomic_numbers]
    crystal.magmoms = np.log1p(np.exp(rho)) * w  # softplus(rho) * w_z


@dataclasses.dataclass
class SyntheticDataset:
    crystals: list[Crystal]
    graphs: list[GraphIndices]
    cfg: SyntheticConfig

    def __len__(self) -> int:
        return len(self.crystals)

    def feature_counts(self) -> np.ndarray:
        """Paper's load metric per sample: atoms + bonds + angles."""
        return np.array([
            g.feature_count(c.num_atoms)
            for c, g in zip(self.crystals, self.graphs)
        ])


def make_dataset(cfg: SyntheticConfig) -> SyntheticDataset:
    rng = np.random.default_rng(cfg.seed)
    element_offsets = rng.normal(-3.0, 1.0, cfg.num_elements + 1)
    magmom_weights = np.abs(rng.normal(0.5, 0.3, cfg.num_elements + 1))
    crystals, graphs = [], []
    for _ in range(cfg.num_crystals):
        c = generate_crystal(rng, cfg)
        g = build_graph(c, cfg.r_cut_atom, cfg.r_cut_bond)
        label_crystal(c, g, element_offsets, magmom_weights)
        crystals.append(c)
        graphs.append(g)
    return SyntheticDataset(crystals=crystals, graphs=graphs, cfg=cfg)
