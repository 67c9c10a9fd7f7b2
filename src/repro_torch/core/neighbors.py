"""Host-side (numpy) periodic neighbor-list and bond-graph construction.

This is the "Molecular Graph Extraction" stage of CHGNet (paper §II-B (1)).
It runs on the host as part of the data pipeline (like pymatgen in the
reference implementation) and emits *index* arrays only; all differentiable
geometry (bond vectors, distances, angles) is recomputed on device inside the
model so that autodiff forces/stress (the reference readout) work.

Atom graph  G^a: directed edges (center i -> neighbor j, image n) with
                 |r_j + n@L - r_i| <= r_cut_atom   (default 6 A).
Bond graph  G^b: nodes are the G^a edges whose length <= r_cut_bond
                 (default 3 A); its edges are ordered pairs of short bonds
                 (ij, ik) sharing center i with j-image != k-image.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Crystal:
    """One crystal structure (host side)."""

    lattice: np.ndarray      # (3, 3) rows are lattice vectors, Angstrom
    frac_coords: np.ndarray  # (N, 3) fractional coordinates in [0, 1)
    atomic_numbers: np.ndarray  # (N,) int
    # Labels (optional; filled by the dataset)
    energy: float | None = None          # eV (total)
    forces: np.ndarray | None = None     # (N, 3) eV/A
    stress: np.ndarray | None = None     # (3, 3) GPa
    magmoms: np.ndarray | None = None    # (N,) mu_B

    @property
    def num_atoms(self) -> int:
        return int(self.frac_coords.shape[0])

    def cart_coords(self) -> np.ndarray:
        return self.frac_coords @ self.lattice


@dataclasses.dataclass
class GraphIndices:
    """Pure index representation of G^a and G^b for one crystal.

    Layout invariant (DESIGN.md §1): ``bond_center`` is non-decreasing and
    ``angle_ij`` is non-decreasing — ``_graph_from_pairs`` canonicalizes
    every producer (``build_graph`` and the Verlet ``update`` refilter), so
    batch packing only has to merge already-sorted runs.

    Mirror maps (DESIGN.md §5): every directed bond (i, j, n) has a mirror
    (j, i, -n); ``bond_pair`` maps each directed bond to its *undirected*
    id, ``bond_sign`` is +1 when the directed bond shares the stored
    orientation of its undirected representative (-1 for the mirror), and
    ``und_rep`` lists, per undirected id, the directed index whose
    (center, nbr, image) triple IS the stored orientation.  Graphs whose
    pair symmetry was broken (``max_nbr_per_atom`` capping) fall back to
    singleton undirected entries, so the maps are total either way.
    ``_graph_from_pairs`` always populates them; hand-built instances may
    leave them ``None`` and let packing repair via ``build_mirror_maps``.
    """

    bond_center: np.ndarray  # (Nb,) int32 atom index i
    bond_nbr: np.ndarray     # (Nb,) int32 atom index j
    bond_image: np.ndarray   # (Nb, 3) int32 periodic image of j
    # bond-graph edges: ordered pairs of *short* bonds sharing a center
    angle_ij: np.ndarray     # (Na,) int32 index into bonds (the updated bond)
    angle_ik: np.ndarray     # (Na,) int32 index into bonds (the partner bond)
    # undirected mirror maps (DESIGN.md §5)
    bond_pair: np.ndarray | None = None  # (Nb,) int32 -> undirected id
    bond_sign: np.ndarray | None = None  # (Nb,) f32 +1 rep orientation, -1 mirror
    und_rep: np.ndarray | None = None    # (Nu,) int32 -> representative bond
    # angle-pair dedup maps: each unordered bond pair {ij, ik} appears
    # twice in the ordered angle list ((ij, ik) and (ik, ij)); the angle
    # cosine is symmetric under the swap, so geometry/Fourier/angle-embed
    # run once per unordered pair (Au == Na/2) and expand via angle_pair
    angle_pair: np.ndarray | None = None     # (Na,) int32 -> und angle id
    und_angle_rep: np.ndarray | None = None  # (Au,) int32 -> representative angle

    @property
    def num_bonds(self) -> int:
        return int(self.bond_center.shape[0])

    @property
    def num_angles(self) -> int:
        return int(self.angle_ij.shape[0])

    @property
    def num_undirected(self) -> int:
        if self.und_rep is None:
            raise ValueError("mirror maps not built; see build_mirror_maps")
        return int(self.und_rep.shape[0])

    @property
    def num_und_angles(self) -> int:
        if self.und_angle_rep is None:
            raise ValueError(
                "angle mirror maps not built; see build_angle_mirror_maps")
        return int(self.und_angle_rep.shape[0])

    def feature_count(self, num_atoms: int) -> int:
        """Paper's load metric: atoms + bonds + angles (Fig. 9)."""
        return num_atoms + self.num_bonds + self.num_angles


def _image_bounds(lattice: np.ndarray, r_cut: float) -> np.ndarray:
    """Number of periodic images needed per axis to cover r_cut.

    Uses the distance between lattice planes: h_k = 1 / ||(L^-1)[:, k]||.
    """
    inv = np.linalg.inv(lattice)
    heights = 1.0 / np.linalg.norm(inv, axis=0)  # (3,)
    return np.ceil(r_cut / heights).astype(np.int64)


def _candidate_pairs(
    lat: np.ndarray, frac: np.ndarray, r_cut: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All (center, neighbor, image) pairs with distance in (0, r_cut].

    The O(N^2 * images) distance tensor here is the expensive part of graph
    construction — the Verlet skin list amortizes it across MD steps.
    Returns (ci, nj, images[int], dist).
    """
    n = frac.shape[0]
    cart = frac @ lat

    nmax = _image_bounds(lat, r_cut)
    rng = [np.arange(-m, m + 1) for m in nmax]
    images = np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, 3)
    shifts = images @ lat  # (M, 3)

    # diff[i, j, m] = r_j + shift_m - r_i
    diff = cart[None, :, None, :] + shifts[None, None, :, :] - cart[:, None, None, :]
    dist = np.linalg.norm(diff, axis=-1)  # (N, N, M)

    mask = (dist <= r_cut) & (dist > 1e-8)
    ci, nj, mi = np.nonzero(mask)
    return ci, nj, images[mi], dist[ci, nj, mi]


def _build_angles(
    bond_center: np.ndarray, bond_dist: np.ndarray, r_cut_bond: float, n: int
) -> tuple[np.ndarray, np.ndarray]:
    """Ordered pairs of *short* bonds sharing a center (G^b edges)."""
    short = np.nonzero(bond_dist <= r_cut_bond)[0]  # indices into bonds
    angle_ij_list: list[np.ndarray] = []
    angle_ik_list: list[np.ndarray] = []
    if short.size > 0:
        centers_short = bond_center[short]
        order = np.argsort(centers_short, kind="stable")
        short_sorted = short[order]
        centers_sorted = centers_short[order]
        # group boundaries
        starts = np.searchsorted(centers_sorted, np.arange(n), side="left")
        ends = np.searchsorted(centers_sorted, np.arange(n), side="right")
        for a in range(n):
            grp = short_sorted[starts[a]:ends[a]]
            d = grp.shape[0]
            if d < 2:
                continue
            jj, kk = np.meshgrid(grp, grp, indexing="ij")
            off = ~np.eye(d, dtype=bool)
            angle_ij_list.append(jj[off].ravel())
            angle_ik_list.append(kk[off].ravel())
    if angle_ij_list:
        angle_ij = np.concatenate(angle_ij_list).astype(np.int32)
        angle_ik = np.concatenate(angle_ik_list).astype(np.int32)
    else:
        angle_ij = np.zeros((0,), dtype=np.int32)
        angle_ik = np.zeros((0,), dtype=np.int32)
    return angle_ij, angle_ik


def _lex_less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise lexicographic a < b for integer (E, K) arrays."""
    res = np.zeros(a.shape[0], dtype=bool)
    decided = np.zeros(a.shape[0], dtype=bool)
    for k in range(a.shape[1]):
        lt = ~decided & (a[:, k] < b[:, k])
        gt = ~decided & (a[:, k] > b[:, k])
        res |= lt
        decided |= lt | gt
    return res


def build_mirror_maps(
    bond_center: np.ndarray,
    bond_nbr: np.ndarray,
    bond_image: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Undirected mirror maps for a directed bond list (DESIGN.md §5).

    A directed bond is the tuple (i, j, n); its mirror is (j, i, -n).  The
    *canonical* form of the pair is the lexicographically smaller of the
    two tuples — i < j ordering with image canonicalization; self-image
    i-j-i bonds (i == j, n != 0) canonicalize on the image alone.  Bonds
    sharing a canonical form are matched into one undirected entry whose
    stored orientation is the canonically-oriented member's; an unmatched
    bond (pair symmetry broken by ``max_nbr_per_atom`` capping) falls back
    to a singleton entry stored in its own orientation, so the maps are
    total and exact for ANY directed bond list.

    Returns ``(bond_pair, bond_sign, und_rep)``:
      - ``bond_pair (E,) int32``: directed -> undirected id,
      - ``bond_sign (E,) f32``: +1 if the directed bond equals its
        representative's orientation, -1 if it is the mirror,
      - ``und_rep (Nu,) int32``: undirected id -> representative directed
        index (strictly increasing — undirected entries are numbered by
        first appearance of their representative, preserving the sorted
        DESIGN.md §1 locality).

    Invariants (checked by ``repro_torch.batching.validate_layout``): every
    undirected id has exactly one sign=+1 reference and at most one
    sign=-1 reference, and ``bond_sign[und_rep] == +1``.
    """
    e_cnt = int(bond_center.shape[0])
    if e_cnt == 0:
        z = np.zeros((0,), np.int32)
        return z, np.zeros((0,), np.float32), z.copy()
    img = bond_image.astype(np.int64)
    fwd = np.column_stack(
        [bond_center.astype(np.int64), bond_nbr.astype(np.int64), img])
    rev = np.column_stack(
        [bond_nbr.astype(np.int64), bond_center.astype(np.int64), -img])
    # fwd == rev would need i == j and n == -n, i.e. the excluded zero-
    # distance self pair — so exactly one direction is canonical
    is_canon = _lex_less(fwd, rev)
    key = np.where(is_canon[:, None], fwd, rev)
    order = np.lexsort(key.T[::-1])
    ks = key[order]
    boundary = np.empty(e_cnt, dtype=bool)
    boundary[0] = True
    boundary[1:] = np.any(ks[1:] != ks[:-1], axis=1)
    gid = np.empty(e_cnt, np.int64)
    gid[order] = np.cumsum(boundary) - 1
    n_groups = int(gid[order[-1]]) + 1
    # representative: the canonically-oriented member when present (the
    # symmetric case), else the lone survivor (capped fallback)
    rep = np.full(n_groups, e_cnt, np.int64)
    canon_idx = np.nonzero(is_canon)[0]
    np.minimum.at(rep, gid[canon_idx], canon_idx)
    first = np.full(n_groups, e_cnt, np.int64)
    np.minimum.at(first, gid, np.arange(e_cnt))
    rep = np.where(rep == e_cnt, first, rep)
    # number undirected entries by representative position (ascending)
    und_order = np.argsort(rep, kind="stable")
    rank = np.empty(n_groups, np.int64)
    rank[und_order] = np.arange(n_groups)
    bond_pair = rank[gid].astype(np.int32)
    und_rep = rep[und_order].astype(np.int32)
    rep_of = rep[gid]
    same = (
        (bond_center == bond_center[rep_of])
        & (bond_nbr == bond_nbr[rep_of])
        & np.all(bond_image == bond_image[rep_of], axis=1)
    )
    bond_sign = np.where(same, 1.0, -1.0).astype(np.float32)
    return bond_pair, bond_sign, und_rep


def build_angle_mirror_maps(
    angle_ij: np.ndarray, angle_ik: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Dedup maps for the ordered angle list (angle-pair mirror treatment).

    ``_build_angles`` emits every *ordered* pair of short bonds sharing a
    center, so each unordered pair {ij, ik} (ij != ik — the meshgrid
    excludes the diagonal) appears exactly twice: (ij, ik) and (ik, ij).
    The angle cosine ``sum(v_ij * v_ik) / (d_ij * d_ik + eps)`` is
    *bitwise* symmetric under the swap (elementwise products commute, the
    component sum runs in the same order), so geometry / Fourier basis /
    angle embedding need only run once per unordered pair.

    Mirrors ``build_mirror_maps``: angles sharing the canonical key
    ``(min(ij, ik), max(ij, ik))`` are matched into one undirected angle
    entry whose stored orientation is the ``ij < ik`` member's; an
    unmatched angle (hand-built asymmetric lists) falls back to a
    singleton entry, so the maps are total for ANY angle list.

    Returns ``(angle_pair, und_angle_rep)``:
      - ``angle_pair (Na,) int32``: angle row -> undirected angle id,
      - ``und_angle_rep (Au,) int32``: undirected angle id ->
        representative angle row (strictly increasing — numbered by first
        appearance, preserving the sorted DESIGN.md §1 locality).

    Invariants (checked by ``repro_torch.batching.validate_layout``): every
    undirected angle id has exactly one same-orientation reference and at
    most one swapped reference.
    """
    a_cnt = int(angle_ij.shape[0])
    if a_cnt == 0:
        z = np.zeros((0,), np.int32)
        return z, z.copy()
    ij = angle_ij.astype(np.int64)
    ik = angle_ik.astype(np.int64)
    lo = np.minimum(ij, ik)
    hi = np.maximum(ij, ik)
    order = np.lexsort((hi, lo))
    ks = np.column_stack([lo, hi])[order]
    boundary = np.empty(a_cnt, dtype=bool)
    boundary[0] = True
    boundary[1:] = np.any(ks[1:] != ks[:-1], axis=1)
    gid = np.empty(a_cnt, np.int64)
    gid[order] = np.cumsum(boundary) - 1
    n_groups = int(np.sum(boundary))
    # representative: the (ij < ik)-oriented member when present, else the
    # first member (asymmetric fallback)
    is_canon = ij < ik
    rep = np.full(n_groups, a_cnt, np.int64)
    canon_idx = np.nonzero(is_canon)[0]
    np.minimum.at(rep, gid[canon_idx], canon_idx)
    first = np.full(n_groups, a_cnt, np.int64)
    np.minimum.at(first, gid, np.arange(a_cnt))
    rep = np.where(rep == a_cnt, first, rep)
    # number undirected entries by representative position (ascending)
    und_order = np.argsort(rep, kind="stable")
    rank = np.empty(n_groups, np.int64)
    rank[und_order] = np.arange(n_groups)
    angle_pair = rank[gid].astype(np.int32)
    und_angle_rep = rep[und_order].astype(np.int32)
    return angle_pair, und_angle_rep


def _mirror_partner(ci: np.ndarray, nj: np.ndarray,
                    images: np.ndarray) -> np.ndarray:
    """Index of each directed pair's mirror (j, i, -n) in the same list.

    Pairs whose mirror is absent (asymmetric input) map to themselves.
    Uses the same canonical-key grouping as ``build_mirror_maps``.
    """
    e_cnt = int(ci.shape[0])
    if e_cnt == 0:
        return np.zeros((0,), np.int64)
    img = images.astype(np.int64)
    fwd = np.column_stack([ci.astype(np.int64), nj.astype(np.int64), img])
    rev = np.column_stack([nj.astype(np.int64), ci.astype(np.int64), -img])
    key = np.where(_lex_less(fwd, rev)[:, None], fwd, rev)
    order = np.lexsort(key.T[::-1])
    ks = key[order]
    boundary = np.empty(e_cnt, dtype=bool)
    boundary[0] = True
    boundary[1:] = np.any(ks[1:] != ks[:-1], axis=1)
    gid = np.empty(e_cnt, np.int64)
    gid[order] = np.cumsum(boundary) - 1
    n_groups = int(np.sum(boundary))
    sums = np.zeros(n_groups, np.int64)
    counts = np.zeros(n_groups, np.int64)
    np.add.at(sums, gid, np.arange(e_cnt))
    np.add.at(counts, gid, 1)
    idx = np.arange(e_cnt)
    return np.where(counts[gid] == 2, sums[gid] - idx, idx)


def _graph_from_pairs(
    ci: np.ndarray,
    nj: np.ndarray,
    images: np.ndarray,
    dist: np.ndarray,
    *,
    n: int,
    r_cut_bond: float,
    max_nbr_per_atom: int | None = None,
    cap_mode: str = "symmetric",
) -> GraphIndices:
    """Assemble GraphIndices from pairs already filtered to r_cut_atom."""
    if cap_mode not in ("symmetric", "per_center"):
        raise ValueError(f"unknown cap_mode {cap_mode!r}")
    if max_nbr_per_atom is not None and ci.size > 0:
        # keep the closest max_nbr_per_atom neighbors per center (cap blowup)
        order = np.lexsort((dist, ci))
        ci, nj, images, dist = ci[order], nj[order], images[order], dist[order]
        counts = np.zeros(n, dtype=np.int64)
        keep = np.zeros(ci.shape[0], dtype=bool)
        for idx, c in enumerate(ci):
            if counts[c] < max_nbr_per_atom:
                keep[idx] = True
                counts[c] += 1
        if cap_mode == "symmetric":
            # symmetry-preserving cap (DESIGN.md §6): keep a directed pair
            # iff BOTH directions survived the greedy per-center pass, so
            # the capped graph stays pair-symmetric (Eu == E/2) and the
            # undirected half-graph store (§5) never needs a singleton
            # fallback.  Per-atom degree can undershoot the cap (a kept
            # slot whose mirror lost out is dropped), never overshoot.
            partner = _mirror_partner(ci, nj, images)
            keep = keep & keep[partner]
        ci, nj, images, dist = ci[keep], nj[keep], images[keep], dist[keep]

    # Sorted-segment invariant: bonds sorted by center (stable — preserves
    # the by-distance neighbor order within a center when capped above).
    # ``_candidate_pairs`` already emits centers in row-major order, so
    # this is a near-identity pass; the Verlet refilter path inherits the
    # guarantee for free since boolean keep-masks preserve order.
    if ci.size and np.any(np.diff(ci) < 0):
        order = np.argsort(ci, kind="stable")
        ci, nj, images, dist = ci[order], nj[order], images[order], dist[order]

    bond_center = ci.astype(np.int32)
    bond_nbr = nj.astype(np.int32)
    bond_image = images.astype(np.int32)

    angle_ij, angle_ik = _build_angles(bond_center, dist, r_cut_bond, n)
    # _build_angles walks centers (and within them, sorted short-bond
    # groups) in ascending order, so angle_ij is non-decreasing already;
    # assert cheaply rather than re-sorting.
    assert angle_ij.size == 0 or np.all(np.diff(angle_ij) >= 0)

    # mirror maps (DESIGN.md §5): recomputed from the filtered pairs, so
    # every producer — build_graph AND the Verlet refilter, whose boolean
    # keep-masks preserve pair symmetry exactly (|-v| == |v| bitwise) —
    # emits canonicalized maps
    bond_pair, bond_sign, und_rep = build_mirror_maps(
        bond_center, bond_nbr, bond_image)
    # angle-pair dedup maps: the ordered angle list holds each unordered
    # {ij, ik} twice — build the (angle_pair, und_angle_rep) maps so the
    # model can run angle geometry/Fourier/embed at Au == Na/2 rows
    angle_pair, und_angle_rep = build_angle_mirror_maps(angle_ij, angle_ik)

    return GraphIndices(
        bond_center=bond_center,
        bond_nbr=bond_nbr,
        bond_image=bond_image,
        angle_ij=angle_ij,
        angle_ik=angle_ik,
        bond_pair=bond_pair,
        bond_sign=bond_sign,
        und_rep=und_rep,
        angle_pair=angle_pair,
        und_angle_rep=und_angle_rep,
    )


def build_graph(
    crystal: Crystal,
    r_cut_atom: float = 6.0,
    r_cut_bond: float = 3.0,
    max_nbr_per_atom: int | None = None,
    cap_mode: str = "symmetric",
) -> GraphIndices:
    """Build G^a / G^b index arrays for one crystal (vectorized numpy).

    ``cap_mode`` governs how ``max_nbr_per_atom`` prunes:
      - ``"symmetric"`` (default): a pair is kept iff both directions
        survive the per-center closest-k pass — the capped graph stays
        pair-symmetric, so Eu == E/2 and the undirected bond store packs
        without an ``und_bonds`` override;
      - ``"per_center"``: the legacy greedy cap (exact closest-k degree
        per atom, may break pair symmetry).
    """
    lat = np.asarray(crystal.lattice, dtype=np.float64)
    frac = np.asarray(crystal.frac_coords, dtype=np.float64)
    ci, nj, images, dist = _candidate_pairs(lat, frac, r_cut_atom)
    return _graph_from_pairs(
        ci, nj, images, dist,
        n=frac.shape[0], r_cut_bond=r_cut_bond,
        max_nbr_per_atom=max_nbr_per_atom,
        cap_mode=cap_mode,
    )


class VerletNeighborList:
    """Skin-radius neighbor-list reuse for MD serving.

    Candidate pairs are built once with ``r_cut_atom + skin``; each step
    only re-measures the candidates' distances (O(Nb) instead of the
    O(N^2 * images) full image search) and re-filters them to
    ``r_cut_atom``.  A full rebuild happens only when some atom has moved
    more than ``skin / 2`` (minimum-image displacement) since the last
    rebuild — the classical Verlet-list guarantee that no pair can enter
    the cutoff unseen.  The per-step refilter keeps the result *exactly*
    equal to a from-scratch ``build_graph`` at the current positions.
    """

    def __init__(
        self,
        crystal: Crystal,
        r_cut_atom: float = 6.0,
        r_cut_bond: float = 3.0,
        skin: float = 0.5,
    ):
        if skin < 0.0:
            raise ValueError(f"skin must be >= 0, got {skin}")
        self.r_cut_atom = r_cut_atom
        self.r_cut_bond = r_cut_bond
        self.skin = skin
        self.rebuilds = 0
        self.updates = 0
        self._rebuild(crystal)

    def _rebuild(self, crystal: Crystal) -> None:
        lat = np.asarray(crystal.lattice, dtype=np.float64)
        frac = np.asarray(crystal.frac_coords, dtype=np.float64)
        ci, nj, images, _ = _candidate_pairs(
            lat, frac, self.r_cut_atom + self.skin
        )
        self._ci, self._nj, self._images = ci, nj, images
        self._ref_lat = lat.copy()
        self._ref_frac = frac.copy()
        self.rebuilds += 1

    def max_displacement(self, crystal: Crystal) -> float:
        """Max minimum-image displacement (A) since the last rebuild."""
        dfrac = np.asarray(crystal.frac_coords, np.float64) - self._ref_frac
        dfrac -= np.round(dfrac)  # wrap-safe: minimum-image convention
        disp = np.linalg.norm(dfrac @ self._ref_lat, axis=-1)
        return float(disp.max()) if disp.size else 0.0

    def needs_rebuild(self, crystal: Crystal) -> bool:
        if not np.allclose(crystal.lattice, self._ref_lat):
            return True
        return self.max_displacement(crystal) > 0.5 * self.skin

    def update(self, crystal: Crystal) -> GraphIndices:
        """Neighbor graph at the crystal's current positions."""
        self.updates += 1
        if self.needs_rebuild(crystal):
            self._rebuild(crystal)
        lat = np.asarray(crystal.lattice, dtype=np.float64)
        frac = np.asarray(crystal.frac_coords, np.float64)
        # MD drivers wrap frac coords into [0, 1) every step; the stored
        # candidate images refer to the *continuous* trajectory.  Recover
        # the integer wrap offsets (exact while displacement < cell/2,
        # guaranteed by the skin/2 rebuild trigger) and shift the images so
        # they stay consistent with the wrapped coordinates the model sees.
        wrap = np.round(frac - self._ref_frac)
        cart = (frac - wrap) @ lat  # continuous (unwrapped) positions
        vec = (cart[self._nj] + self._images @ lat - cart[self._ci])
        dist = np.linalg.norm(vec, axis=-1)
        keep = (dist <= self.r_cut_atom) & (dist > 1e-8)
        images = (
            self._images[keep]
            - wrap[self._nj[keep]].astype(np.int64)
            + wrap[self._ci[keep]].astype(np.int64)
        )
        return _graph_from_pairs(
            self._ci[keep], self._nj[keep], images, dist[keep],
            n=crystal.num_atoms, r_cut_bond=self.r_cut_bond,
        )
