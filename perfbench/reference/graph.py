"""Plain NumPy crystal graphs: the benchmark's own neighbor lists.

CHGNet's two graphs (Deng et al., Nat. Mach. Intell. 2023, Methods):

  - the atom graph: every directed pair (center i, neighbor j, periodic
    image n) with 0 < |r_j + n L - r_i| <= r_cut_atom;
  - the bond graph: every ordered pair of distinct atom-graph bonds that
    share their center and are both no longer than r_cut_bond.

Written from that definition alone; it imports nothing of the program.
The benchmark labels its crystals with these pairs, holds the program's
packed batches to them (``batch_mismatches``) and feeds them to the
reference model.
"""
from __future__ import annotations

import numpy as np


def _image_range(lattice: np.ndarray, r_cut: float) -> np.ndarray:
    """Images per axis that reach r_cut: the cutoff over the distance
    between the lattice planes of that axis, rounded up."""
    heights = 1.0 / np.linalg.norm(np.linalg.inv(lattice), axis=0)
    return np.ceil(r_cut / heights).astype(np.int64)


def pairs(lattice: np.ndarray, frac: np.ndarray, r_cut: float):
    """Directed atom-graph bonds of one crystal in float64.

    Returns ``(center, nbr, image (E, 3) int64, vec (E, 3), dist (E,))``
    with ``vec = r_nbr + image @ lattice - r_center``.
    """
    lattice = np.asarray(lattice, np.float64)
    cart = np.asarray(frac, np.float64) @ lattice
    m = _image_range(lattice, r_cut)
    grid = np.stack(np.meshgrid(*(np.arange(-k, k + 1) for k in m),
                                indexing="ij"), axis=-1).reshape(-1, 3)
    shifts = grid @ lattice
    # (center, nbr, image) -> vector
    vec = (cart[None, :, None, :] + shifts[None, None, :, :]
           - cart[:, None, None, :])
    dist = np.sqrt(np.einsum("ijmk,ijmk->ijm", vec, vec))
    ci, nj, mi = np.nonzero((dist <= r_cut) & (dist > 1e-8))
    return ci, nj, grid[mi], vec[ci, nj, mi], dist[ci, nj, mi]


def angles(center: np.ndarray, dist: np.ndarray, r_cut_bond: float):
    """Bond-graph edges: every ordered pair (ij, ik), ij != ik, of bonds
    with one center and both lengths <= r_cut_bond.  Returns the two bond
    index arrays."""
    short = np.nonzero(dist <= r_cut_bond)[0]
    short = short[np.argsort(center[short], kind="stable")]
    if short.size == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy()
    c = center[short]
    start = np.searchsorted(c, c, side="left")
    size = np.searchsorted(c, c, side="right") - start
    # each short bond pairs with every member of its center's group
    owner = np.repeat(np.arange(short.size), size)
    first = np.repeat(np.cumsum(size) - size, size)
    member = start[owner] + np.arange(owner.size) - first
    keep = member != owner
    return short[owner[keep]], short[member[keep]]


def crystal_graph(lattice, frac, r_cut_atom: float, r_cut_bond: float):
    """Both graphs of one crystal as a dict of arrays."""
    ci, nj, img, vec, dist = pairs(lattice, frac, r_cut_atom)
    ij, ik = angles(ci, dist, r_cut_bond)
    return {"center": ci, "nbr": nj, "image": img, "dist": dist,
            "angle_ij": ij, "angle_ik": ik}


def concat(crystals, graphs):
    """The graphs of several crystals as one disjoint graph: atom and bond
    ids offset crystal by crystal, in the order given.  Returns a dict of
    host arrays (labels float64)."""
    a_off = np.cumsum([0] + [len(c["z"]) for c in crystals])
    b_off = np.cumsum([0] + [len(g["center"]) for g in graphs])

    def cat(key, src, off=None):
        parts = [x[key] + (0 if off is None else off[i])
                 for i, x in enumerate(src)]
        return np.concatenate(parts)

    return {
        "z": cat("z", crystals),
        "frac": cat("frac", crystals),
        "lattice": np.stack([c["lattice"] for c in crystals]),
        "atom_crystal": np.repeat(np.arange(len(crystals)), np.diff(a_off)),
        "center": cat("center", graphs, a_off),
        "nbr": cat("nbr", graphs, a_off),
        "image": cat("image", graphs),
        "bond_crystal": np.repeat(np.arange(len(graphs)), np.diff(b_off)),
        "angle_ij": cat("angle_ij", graphs, b_off),
        "angle_ik": cat("angle_ik", graphs, b_off),
        "energy": np.array([c["energy"] for c in crystals]),
        "forces": cat("forces", crystals),
        "stress": np.stack([c["stress"] for c in crystals]),
        "magmoms": cat("magmoms", crystals),
        "n_atoms": np.diff(a_off),
    }


def _bond_keys(center, nbr, image, n_atoms: int) -> np.ndarray:
    """One int64 per directed bond (images lie within +-31)."""
    img = np.asarray(image).astype(np.int64) + 32
    return (((np.asarray(center, np.int64) * n_atoms
              + np.asarray(nbr, np.int64)) * 64 + img[:, 0]) * 64
            + img[:, 1]) * 64 + img[:, 2]


def _mismatched(got: np.ndarray, want: np.ndarray) -> int:
    """0 when the two multisets are equal, else at least 1: the entries
    that one of them lacks, plus the difference in size."""
    got, want = np.sort(got), np.sort(want)
    if got.shape == want.shape and np.array_equal(got, want):
        return 0
    return max(1, int(np.setxor1d(got, want).size
                      + abs(got.size - want.size)))


def batch_mismatches(batch: dict, ref: dict) -> dict:
    """Entries of a packed batch (host arrays of the program's batch,
    keyed as its fields) that differ from the reference graph ``ref``
    (``concat``) of the same crystals in the same order.

    Atoms, lattices and labels are compared exactly after the float32
    cast that packing applies; bonds as the multiset of (center, nbr,
    image) among the real rows; angles as the multiset of their bond
    pairs.  Padding is checked to be masked out, and the counts of real
    atoms and crystals to be the reference's.  Returns a count per part;
    every count is 0 for a sound batch.
    """
    f32 = np.float32
    out = {}
    # rows the batch marks real, against the reference's counts
    na_b, nc_b = int(batch["atom_mask"].sum()), int(batch["crystal_mask"]
                                                     .sum())
    na, nc = min(na_b, len(ref["z"])), min(nc_b, len(ref["energy"]))
    out["counts"] = abs(na_b - len(ref["z"])) + abs(nc_b - len(ref["energy"]))
    nb = int(batch["bond_offsets"][-1])
    ng = int(batch["angle_offsets"][-1])
    out["masks"] = int(
        (batch["atom_mask"][:na_b] != 1).sum()
        + (batch["crystal_mask"][:nc_b] != 1).sum()
        + (batch["bond_mask"][:nb] != 1).sum() + batch["bond_mask"][nb:].sum()
        + (batch["angle_mask"][:ng] != 1).sum()
        + batch["angle_mask"][ng:].sum())
    out["atoms"] = int(
        (batch["atom_z"][:na] != ref["z"][:na]).sum()
        + (batch["frac_coords"][:na] != ref["frac"][:na].astype(f32)).sum()
        + (batch["atom_crystal"][:na] != ref["atom_crystal"][:na]).sum()
        + (batch["lattice"][:nc] != ref["lattice"][:nc].astype(f32)).sum())
    out["labels"] = int(
        (batch["energy"][:nc] != ref["energy"][:nc].astype(f32)).sum()
        + (batch["forces"][:na] != ref["forces"][:na].astype(f32)).sum()
        + (batch["stress"][:nc] != ref["stress"][:nc].astype(f32)).sum()
        + (batch["magmoms"][:na] != ref["magmoms"][:na].astype(f32)).sum()
        + (batch["n_atoms_per_crystal"][:nc] != ref["n_atoms"][:nc]).sum())
    n_ids = max(na_b, len(ref["z"]))
    got_bonds = _bond_keys(batch["bond_center"][:nb], batch["bond_nbr"][:nb],
                           np.rint(batch["bond_image"][:nb]), n_ids)
    want_bonds = _bond_keys(ref["center"], ref["nbr"], ref["image"], n_ids)
    out["bonds"] = _mismatched(got_bonds, want_bonds)
    # angles as pairs of bond ranks in the reference's sorted bond keys
    order = np.sort(want_bonds)
    n_ref = order.size + 1

    def rank(keys):
        pos = np.searchsorted(order, keys)
        hit = (pos < order.size) & (order[np.minimum(pos, order.size - 1)]
                                    == keys)
        return np.where(hit, pos, order.size)

    got_rank = rank(got_bonds)
    ij, ik = batch["angle_ij"][:ng], batch["angle_ik"][:ng]
    inside = (ij >= 0) & (ij < nb) & (ik >= 0) & (ik < nb)
    got_ang = got_rank[np.where(inside, ij, 0)] * n_ref \
        + got_rank[np.where(inside, ik, 0)]
    got_ang = np.where(inside, got_ang, -1)
    want_rank = rank(want_bonds)
    want_ang = want_rank[ref["angle_ij"]] * n_ref + want_rank[ref["angle_ik"]]
    out["angles"] = _mismatched(got_ang, want_ang)
    return out
