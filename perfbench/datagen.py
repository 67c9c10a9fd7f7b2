"""The benchmark's synthetic crystals and labels, made from a seed.

A frozen copy of the port's synthetic MPtrj-like generator (lognormal
crystal sizes, paper Fig. 5; cubic cells of ``vol_per_atom`` per atom with
a 3% random distortion, uniform positions, elements 1..``num_elements``)
and of its analytic labels:

    E = 1/2 sum_directed Morse(r_ij) + sum_i mu_{z_i}
    F_i = sum_j Morse'(r_ij) (r_j - r_i) / r_ij
    sigma = 1/(2V) sum_directed Morse'(r)/r (r_vec x r_vec)   [GPa]
    m_i = softplus(sum_j exp(-r_ij)) w_{z_i}

With ``size_seed`` null the draws follow the port's ``make_dataset`` in
order, so one seed gives its crystals.  A traffic mix gives a
``size_seed``: the crystal sizes are then drawn once from it and only
shuffled by the run's seed, so that every seed trains on the same sizes
and the work per epoch does not depend on the seed.

Plain NumPy; the pairs come from ``reference.graph``.
"""
from __future__ import annotations

import numpy as np

from perfbench.reference.graph import pairs

_DE, _A, _R0 = 0.5, 1.3, 2.6   # Morse (eV, 1/A, A)
EV_A3_TO_GPA = 160.21766


def _morse(r):
    e = np.exp(-_A * (r - _R0))
    return _DE * (e * e - 2.0 * e)


def _morse_dr(r):
    e = np.exp(-_A * (r - _R0))
    return _DE * (-2.0 * _A * e * e + 2.0 * _A * e)


def _size(draw: float, sizes: dict) -> int:
    return int(np.clip(draw, sizes["min_atoms"], sizes["max_atoms"]))


def label(crystal: dict, r_cut: float, offsets: np.ndarray,
          weights: np.ndarray) -> None:
    """Energy, forces, stress and magmoms of ``crystal``, in place."""
    lat, z = crystal["lattice"], crystal["z"]
    ci, _, _, vec, dist = pairs(lat, crystal["frac"], r_cut)
    n = len(z)
    dphi = _morse_dr(dist)
    crystal["energy"] = float(0.5 * np.sum(_morse(dist))
                              + np.sum(offsets[z]))
    forces = np.zeros((n, 3))
    np.add.at(forces, ci, dphi[:, None] * vec / dist[:, None])
    crystal["forces"] = forces
    outer = vec[:, :, None] * vec[:, None, :]
    vol = abs(np.linalg.det(lat))
    crystal["stress"] = (0.5 * np.sum((dphi / dist)[:, None, None] * outer,
                                      axis=0) / vol * EV_A3_TO_GPA)
    rho = np.zeros(n)
    np.add.at(rho, ci, np.exp(-dist))
    crystal["magmoms"] = np.log1p(np.exp(rho)) * weights[z]


def make_crystals(mix: dict, seed: int, r_cut_atom: float) -> list[dict]:
    """The mix's pool of labelled crystals for ``seed``: dicts of
    ``lattice``, ``frac``, ``z`` and the labels (float64, int64 ``z``)."""
    sizes = mix["sizes"]
    ne = mix["num_elements"]
    rng = np.random.default_rng(seed)
    offsets = rng.normal(-3.0, 1.0, ne + 1)
    weights = np.abs(rng.normal(0.5, 0.3, ne + 1))
    counts = None
    if sizes.get("size_seed") is not None:
        fixed = np.random.default_rng(sizes["size_seed"]).lognormal(
            sizes["lognormal_mu"], sizes["lognormal_sigma"], mix["pool"])
        counts = rng.permutation([_size(x, sizes) for x in fixed])
    out = []
    for k in range(mix["pool"]):
        n = _size(rng.lognormal(sizes["lognormal_mu"],
                                sizes["lognormal_sigma"]), sizes) \
            if counts is None else int(counts[k])
        a = (n * mix["vol_per_atom"]) ** (1.0 / 3.0)
        crystal = {
            "lattice": np.eye(3) * a + rng.normal(0.0, 0.03 * a, (3, 3)),
            "frac": rng.random((n, 3)),
            "z": rng.integers(1, ne + 1, n),
        }
        label(crystal, r_cut_atom, offsets, weights)
        out.append(crystal)
    return out
