"""Synthetic MPtrj-like crystals (offline stand-in for the licensed MPtrj).

A copy of the structure generator of ``repro.data.synthetic``: a random
number of atoms from a long-tailed lognormal (paper Fig. 5), 14 A^3 per
atom, a perturbed cubic lattice and uniform fractional coordinates.  The
analytic labels are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.neighbors import Crystal


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
