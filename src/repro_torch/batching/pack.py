"""Host-side packing of crystals into padded ``CrystalGraphBatch``es.

A copy of ``repro.batching.pack``'s numpy body: the packed arrays are
bitwise equal to the JAX package's for the same crystals, graphs and
capacities.  Only the final conversion differs — ``torch.from_numpy``
wraps the host arrays as a CPU batch, which the caller moves to the card
with ``CrystalGraphBatch.to``.

Padding convention (unchanged from the seed): real entries are packed at
the front, masks mark validity, padded bonds/angles point at slot 0 with
zeroed payloads so segment-sums are unaffected.  ``num_crystal_slots``
additionally pads the *crystal* axis, so shards with unequal numbers of
structures (non-divisible global batches) still stack to one fixed shape.

Sorted-segment layout (DESIGN.md §1): on top of the padding convention,
packing canonicalizes the graph indices so that

  - real bonds are sorted by ``bond_center`` (stable, so per-center
    neighbor order is preserved),
  - real angles are sorted by ``angle_ij`` after remapping through the
    bond permutation,
  - CSR row pointers ``bond_offsets: (atom_cap+1,)`` and
    ``angle_offsets: (bond_cap+1,)`` delimit each segment's contiguous run
    (last entry == number of real entries, excluding the padded tail).

Undirected half-graph store (DESIGN.md §5): alongside the directed
arrays, packing emits a once-per-pair ``und_*`` store (capacity
``caps.und_cap`` ≈ bonds/2) plus the mirror maps ``bond_pair`` /
``bond_sign`` that materialize directed views (``vec_dir = sign ⊙
vec_und[bond_pair]``).  The directed index arrays are untouched, so the
§1 sorted-CSR invariant — and every consumer of it — is preserved.

``validate_layout`` checks both invariants cheaply (a few O(E) numpy
passes); packing validates by default so every producer — the training
pipeline, the serve engine's Verlet rebuild path — emits certified-sorted
batches that the fused aggregation kernels can consume without atomics.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import CrystalGraphBatch
from repro_torch.core.neighbors import (
    Crystal,
    GraphIndices,
    build_angle_mirror_maps,
    build_mirror_maps,
)

from .capacity import BatchCapacities


def _csr_offsets(sorted_ids: np.ndarray, num_segments: int) -> np.ndarray:
    """Row pointers for sorted segment ids: offsets[s] = first index of s."""
    return np.searchsorted(
        sorted_ids, np.arange(num_segments + 1)
    ).astype(np.int32)


def batch_crystals(
    crystals: list[Crystal],
    graphs: list[GraphIndices],
    caps: BatchCapacities,
    *,
    num_crystal_slots: int | None = None,
    dtype=np.float32,
    validate: bool = True,
) -> CrystalGraphBatch:
    """Pack crystals + pre-built graph indices into one padded batch.

    Raises ValueError if the batch exceeds the capacities (callers should
    size capacities from dataset statistics / the bucketing policy).
    Padded crystal slots (``num_crystal_slots > len(crystals)``) get
    identity lattices and zero ``crystal_mask``.

    The result satisfies the sorted-segment layout invariant (module
    docstring / DESIGN.md §1); ``validate=False`` skips the final check
    for hot loops that trust their graph producers.
    """
    b = num_crystal_slots if num_crystal_slots is not None else len(crystals)
    if len(crystals) > b:
        raise ValueError(
            f"{len(crystals)} crystals exceed {b} crystal slots"
        )
    tot_atoms = sum(c.num_atoms for c in crystals)
    tot_bonds = sum(g.num_bonds for g in graphs)
    tot_angles = sum(g.num_angles for g in graphs)
    if not caps.fits(tot_atoms, tot_bonds, tot_angles):
        raise ValueError(
            f"batch ({tot_atoms} atoms, {tot_bonds} bonds, {tot_angles} angles)"
            f" exceeds capacities {caps}"
        )
    # undirected half-graph store (DESIGN.md §5): repair missing mirror
    # maps (hand-built GraphIndices) once, up front
    mirrors = [
        (g.bond_pair, g.bond_sign, g.und_rep)
        if g.bond_pair is not None
        else build_mirror_maps(g.bond_center, g.bond_nbr, g.bond_image)
        for g in graphs
    ]
    und_cap = caps.und_cap
    tot_und = sum(int(m[2].shape[0]) for m in mirrors)
    if tot_und > und_cap:
        raise ValueError(
            f"batch has {tot_und} undirected bonds, exceeding und_cap "
            f"{und_cap}; pair symmetry was likely broken by "
            f"max_nbr_per_atom capping — pass BatchCapacities(..., "
            f"und_bonds=...) with explicit headroom"
        )
    # angle-pair dedup store: same repair-or-reuse treatment as the bond
    # mirror maps (the angle cosine is swap-symmetric, so each unordered
    # {ij, ik} pair is stored once and expanded via angle_pair)
    a_mirrors = [
        (g.angle_pair, g.und_angle_rep)
        if g.angle_pair is not None
        else build_angle_mirror_maps(g.angle_ij, g.angle_ik)
        for g in graphs
    ]
    ua_cap = caps.und_angle_cap
    tot_ua = sum(int(m[1].shape[0]) for m in a_mirrors)
    if tot_ua > ua_cap:
        raise ValueError(
            f"batch has {tot_ua} deduplicated angles, exceeding "
            f"und_angle_cap {ua_cap}; the angle list is likely asymmetric "
            f"(hand-built) — pass BatchCapacities(..., und_angles=...) "
            f"with explicit headroom"
        )

    atom_z = np.zeros((caps.atoms,), np.int32)
    atom_mask = np.zeros((caps.atoms,), dtype)
    atom_crystal = np.zeros((caps.atoms,), np.int32)
    frac = np.zeros((caps.atoms, 3), dtype)
    # identity lattices on padded slots keep det/inverse well-defined
    lattice = np.tile(np.eye(3, dtype=dtype)[None], (b, 1, 1))
    crystal_mask = np.zeros((b,), dtype)
    bond_center = np.zeros((caps.bonds,), np.int32)
    bond_nbr = np.zeros((caps.bonds,), np.int32)
    bond_image = np.zeros((caps.bonds, 3), dtype)
    bond_crystal = np.zeros((caps.bonds,), np.int32)
    bond_mask = np.zeros((caps.bonds,), dtype)
    angle_ij = np.zeros((caps.angles,), np.int32)
    angle_ik = np.zeros((caps.angles,), np.int32)
    angle_mask = np.zeros((caps.angles,), dtype)
    bond_pair = np.zeros((caps.bonds,), np.int32)
    bond_sign = np.zeros((caps.bonds,), dtype)
    und_center = np.zeros((und_cap,), np.int32)
    und_nbr = np.zeros((und_cap,), np.int32)
    und_image = np.zeros((und_cap, 3), dtype)
    und_crystal = np.zeros((und_cap,), np.int32)
    und_mask = np.zeros((und_cap,), dtype)
    angle_pair = np.zeros((caps.angles,), np.int32)
    und_angle_ij = np.zeros((ua_cap,), np.int32)
    und_angle_ik = np.zeros((ua_cap,), np.int32)
    und_angle_mask = np.zeros((ua_cap,), dtype)
    energy = np.zeros((b,), dtype)
    forces = np.zeros((caps.atoms, 3), dtype)
    stress = np.zeros((b, 3, 3), dtype)
    magmoms = np.zeros((caps.atoms,), dtype)
    n_atoms = np.zeros((b,), dtype)

    a_off = 0
    b_off = 0
    g_off = 0
    u_off = 0
    ua_off = 0
    for ci, (c, g, (g_pair, g_sign, g_rep), (g_apair, g_arep)) in enumerate(
            zip(crystals, graphs, mirrors, a_mirrors)):
        na, nb, ng = c.num_atoms, g.num_bonds, g.num_angles
        nu = int(g_rep.shape[0])
        nua = int(g_arep.shape[0])
        atom_z[a_off:a_off + na] = c.atomic_numbers
        atom_mask[a_off:a_off + na] = 1.0
        atom_crystal[a_off:a_off + na] = ci
        frac[a_off:a_off + na] = c.frac_coords
        lattice[ci] = c.lattice
        crystal_mask[ci] = 1.0
        n_atoms[ci] = na
        bond_center[b_off:b_off + nb] = g.bond_center + a_off
        bond_nbr[b_off:b_off + nb] = g.bond_nbr + a_off
        bond_image[b_off:b_off + nb] = g.bond_image.astype(dtype)
        bond_crystal[b_off:b_off + nb] = ci
        bond_mask[b_off:b_off + nb] = 1.0
        angle_ij[g_off:g_off + ng] = g.angle_ij + b_off
        angle_ik[g_off:g_off + ng] = g.angle_ik + b_off
        angle_mask[g_off:g_off + ng] = 1.0
        bond_pair[b_off:b_off + nb] = g_pair + u_off
        bond_sign[b_off:b_off + nb] = g_sign
        und_center[u_off:u_off + nu] = g.bond_center[g_rep] + a_off
        und_nbr[u_off:u_off + nu] = g.bond_nbr[g_rep] + a_off
        und_image[u_off:u_off + nu] = g.bond_image[g_rep].astype(dtype)
        und_crystal[u_off:u_off + nu] = ci
        und_mask[u_off:u_off + nu] = 1.0
        angle_pair[g_off:g_off + ng] = g_apair + ua_off
        und_angle_ij[ua_off:ua_off + nua] = g.angle_ij[g_arep] + b_off
        und_angle_ik[ua_off:ua_off + nua] = g.angle_ik[g_arep] + b_off
        und_angle_mask[ua_off:ua_off + nua] = 1.0
        if c.energy is not None:
            energy[ci] = c.energy
        if c.forces is not None:
            forces[a_off:a_off + na] = c.forces
        if c.stress is not None:
            stress[ci] = c.stress
        if c.magmoms is not None:
            magmoms[a_off:a_off + na] = c.magmoms
        a_off += na
        b_off += nb
        g_off += ng
        u_off += nu
        ua_off += nua

    # Canonicalize to the sorted-segment layout. ``build_graph`` already
    # emits per-crystal indices sorted by center, and crystals are packed
    # in atom order, so these stable argsorts are near-identity — the cost
    # is one O(E log E) pass that certifies the invariant regardless of
    # where the graphs came from.
    perm_b = np.argsort(bond_center[:b_off], kind="stable")
    for arr in (bond_center, bond_nbr, bond_image, bond_crystal, bond_mask,
                bond_pair, bond_sign):
        arr[:b_off] = arr[perm_b]
    # angles index into bonds: remap through the bond permutation first
    inv_b = np.empty_like(perm_b)
    inv_b[perm_b] = np.arange(b_off)
    if g_off:
        angle_ij[:g_off] = inv_b[angle_ij[:g_off]]
        angle_ik[:g_off] = inv_b[angle_ik[:g_off]]
    # the dedup-angle store indexes bonds too — remap, but never re-sort
    # (it's a side table addressed through angle_pair, like the und bonds)
    if ua_off:
        und_angle_ij[:ua_off] = inv_b[und_angle_ij[:ua_off]]
        und_angle_ik[:ua_off] = inv_b[und_angle_ik[:ua_off]]
    perm_a = np.argsort(angle_ij[:g_off], kind="stable")
    for arr in (angle_ij, angle_ik, angle_mask, angle_pair):
        arr[:g_off] = arr[perm_a]
    bond_offsets = _csr_offsets(bond_center[:b_off], caps.atoms)
    angle_offsets = _csr_offsets(angle_ij[:g_off], caps.bonds)
    # symmetric-trunk incidence store (DESIGN.md §10): every real dedup
    # angle (Au row) w scatters its single message to BOTH undirected
    # bonds of its pair — incidences (bond_pair[und_angle_ij[w]], w) and
    # (bond_pair[und_angle_ik[w]], w) — so each real Au row appears
    # exactly twice.  On symmetric angle lists (everything the neighbor
    # builders emit) this equals deriving one incidence per directed
    # angle, so the real incidence count == the real directed-angle
    # count.  Built from the FINAL (canonicalized) arrays, dest-sorted so
    # every aggregation tier — including the Eu destination-tiled
    # megakernel — owns contiguous runs.
    n_incid = 2 * ua_off
    if n_incid > caps.angles:
        raise ValueError(
            f"batch needs {n_incid} symmetric incidences but angle_cap is "
            f"{caps.angles}; the angle list is likely asymmetric "
            "(hand-built, missing swapped orientations)")
    sym_dest = np.zeros((caps.angles,), np.int32)
    sym_rep = np.zeros((caps.angles,), np.int32)
    if ua_off:
        dest = np.concatenate([bond_pair[und_angle_ij[:ua_off]],
                               bond_pair[und_angle_ik[:ua_off]]])
        rep = np.concatenate([np.arange(ua_off, dtype=np.int32)] * 2)
        order = np.argsort(dest, kind="stable")
        sym_dest[:n_incid] = dest[order]
        sym_rep[:n_incid] = rep[order]
    sym_offsets = _csr_offsets(sym_dest[:n_incid], und_cap)

    if validate:
        # validate the host arrays before wrapping them — same
        # certification as validate_layout(batch) on the numpy arrays
        _validate_arrays(bond_mask, angle_mask, bond_center, angle_ij,
                         bond_offsets, angle_offsets,
                         atom_cap=caps.atoms, bond_cap=caps.bonds)
        _validate_row_crystals(bond_mask, bond_center, bond_crystal,
                               bond_offsets)
        _validate_mirror(bond_mask, bond_center, bond_nbr, bond_image,
                         bond_crystal, bond_pair, bond_sign, und_center,
                         und_nbr, und_image, und_crystal, und_mask)
        _validate_angle_mirror(angle_mask, angle_ij, angle_ik, angle_pair,
                               und_angle_ij, und_angle_ik, und_angle_mask)
        _validate_sym_incidence(bond_pair, und_angle_ij, und_angle_ik,
                                und_angle_mask, sym_dest, sym_rep,
                                sym_offsets)

    return CrystalGraphBatch.from_numpy(dict(
        atom_z=atom_z,
        atom_mask=atom_mask,
        atom_crystal=atom_crystal,
        frac_coords=frac,
        lattice=lattice,
        crystal_mask=crystal_mask,
        bond_center=bond_center,
        bond_nbr=bond_nbr,
        bond_image=bond_image,
        bond_crystal=bond_crystal,
        bond_mask=bond_mask,
        angle_ij=angle_ij,
        angle_ik=angle_ik,
        angle_mask=angle_mask,
        bond_offsets=bond_offsets,
        angle_offsets=angle_offsets,
        bond_pair=bond_pair,
        bond_sign=bond_sign,
        und_center=und_center,
        und_nbr=und_nbr,
        und_image=und_image,
        und_crystal=und_crystal,
        und_mask=und_mask,
        angle_pair=angle_pair,
        und_angle_ij=und_angle_ij,
        und_angle_ik=und_angle_ik,
        und_angle_mask=und_angle_mask,
        sym_dest=sym_dest,
        sym_rep=sym_rep,
        sym_offsets=sym_offsets,
        energy=energy,
        forces=forces,
        stress=stress,
        magmoms=magmoms,
        n_atoms_per_crystal=n_atoms,
    ))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"sorted-segment layout violated: {msg}")


def validate_layout(batch: CrystalGraphBatch) -> CrystalGraphBatch:
    """Cheap host-side check of the sorted-segment layout invariant.

    Verifies (a few O(E) numpy passes): masks are contiguous real-prefix
    indicators, real bonds/angles are sorted by their segment key, the
    CSR row pointers exactly describe the segment runs, every real bond
    of an atom row carries the row's crystal id, and the mirror
    maps of the undirected half-graph store (DESIGN.md §5) exactly
    reconstruct every real directed bond.  Copies the fields to the host,
    so use it on externally produced batches; the pack path validates its
    numpy arrays before wrapping them instead.  Returns the batch for
    chaining; raises ValueError with the broken condition.
    """
    h = batch.numpy()
    _validate_arrays(
        h["bond_mask"], h["angle_mask"], h["bond_center"], h["angle_ij"],
        h["bond_offsets"], h["angle_offsets"],
        atom_cap=batch.atom_cap, bond_cap=batch.bond_cap,
    )
    _validate_row_crystals(h["bond_mask"], h["bond_center"],
                           h["bond_crystal"], h["bond_offsets"])
    _validate_mirror(
        h["bond_mask"], h["bond_center"], h["bond_nbr"], h["bond_image"],
        h["bond_crystal"], h["bond_pair"], h["bond_sign"], h["und_center"],
        h["und_nbr"], h["und_image"], h["und_crystal"], h["und_mask"],
    )
    _validate_angle_mirror(
        h["angle_mask"], h["angle_ij"], h["angle_ik"], h["angle_pair"],
        h["und_angle_ij"], h["und_angle_ik"], h["und_angle_mask"],
    )
    _validate_sym_incidence(
        h["bond_pair"], h["und_angle_ij"], h["und_angle_ik"],
        h["und_angle_mask"], h["sym_dest"], h["sym_rep"], h["sym_offsets"],
    )
    return batch


def _validate_arrays(bond_mask, angle_mask, bond_center, angle_ij,
                     bond_offsets, angle_offsets, *,
                     atom_cap: int, bond_cap: int) -> None:
    _check(bond_offsets.shape == (atom_cap + 1,),
           f"bond_offsets shape {bond_offsets.shape}")
    _check(angle_offsets.shape == (bond_cap + 1,),
           f"angle_offsets shape {angle_offsets.shape}")
    for name, mask, ids, offs in (
        ("bond", bond_mask, bond_center, bond_offsets),
        ("angle", angle_mask, angle_ij, angle_offsets),
    ):
        n_real = int(mask.sum())
        _check(np.all(mask[:n_real] == 1.0) and np.all(mask[n_real:] == 0.0),
               f"{name}_mask is not a real-prefix indicator")
        _check(np.all(np.diff(ids[:n_real]) >= 0),
               f"real {name}s not sorted by segment id")
        _check(offs[0] == 0 and offs[-1] == n_real,
               f"{name}_offsets endpoints != (0, {n_real})")
        _check(np.all(np.diff(offs) >= 0),
               f"{name}_offsets not monotone")
        expect = np.searchsorted(ids[:n_real], np.arange(offs.shape[0]))
        _check(np.array_equal(offs, expect),
               f"{name}_offsets disagree with sorted {name} segment ids")


def _validate_row_crystals(bond_mask, bond_center, bond_crystal,
                           bond_offsets) -> None:
    """Every real bond of an atom row carries the crystal of the row's
    first bond, as a bond lies in its center atom's crystal.  Kernel 4b's
    per-crystal sum (``fused_force_virial_readout`` on the card) counts a
    row in that crystal; crystal slots themselves may come in any order.
    Needs the row pointers ``_validate_arrays`` certifies."""
    nb = int(bond_mask.sum())
    first = bond_offsets[bond_center[:nb]]
    _check(np.array_equal(bond_crystal[:nb], bond_crystal[first]),
           "an atom row's bonds carry more than one crystal id")


def _validate_mirror(bond_mask, bond_center, bond_nbr, bond_image,
                     bond_crystal, bond_pair, bond_sign, und_center,
                     und_nbr, und_image, und_crystal, und_mask) -> None:
    """Mirror invariant of the undirected store (DESIGN.md §5).

    For every real directed bond e with p = bond_pair[e]:
      sign=+1  =>  (center, nbr, image)[e] == (und_center, und_nbr,
                   und_image)[p]          (the stored orientation)
      sign=-1  =>  (center, nbr, image)[e] == (und_nbr, und_center,
                   -und_image)[p]         (the mirror)
    plus: crystal ids agree, each real undirected row is referenced by
    exactly one sign=+1 bond and at most one sign=-1 bond, und_mask is a
    real-prefix indicator, and padded directed bonds carry (pair=0,
    sign=0) so their expanded vectors vanish.
    """
    nb = int(bond_mask.sum())
    nu = int(und_mask.sum())
    _check(np.all(und_mask[:nu] == 1.0) and np.all(und_mask[nu:] == 0.0),
           "und_mask is not a real-prefix indicator")
    _check(np.all(bond_pair[nb:] == 0) and np.all(bond_sign[nb:] == 0.0),
           "padded directed bonds must carry (pair=0, sign=0)")
    p = bond_pair[:nb]
    s = bond_sign[:nb]
    _check(np.all((p >= 0) & (p < max(nu, 1))),
           "bond_pair out of range of the real undirected prefix")
    _check(np.all(np.abs(s) == 1.0), "real bond_sign must be ±1")
    plus, minus = s > 0, s < 0
    same = (
        (bond_center[:nb] == und_center[p])
        & (bond_nbr[:nb] == und_nbr[p])
        & np.all(bond_image[:nb] == und_image[p], axis=-1)
    )
    flip = (
        (bond_center[:nb] == und_nbr[p])
        & (bond_nbr[:nb] == und_center[p])
        & np.all(bond_image[:nb] == -und_image[p], axis=-1)
    )
    _check(np.all(same[plus]), "sign=+1 bonds disagree with their und row")
    _check(np.all(flip[minus]), "sign=-1 bonds are not exact mirrors")
    _check(np.all(bond_crystal[:nb] == und_crystal[p]),
           "bond/und crystal ids disagree")
    refs_plus = np.bincount(p[plus], minlength=nu)
    refs_minus = np.bincount(p[minus], minlength=nu)
    _check(np.all(refs_plus == 1),
           "each und row needs exactly one sign=+1 reference")
    _check(np.all(refs_minus <= 1),
           "an und row has more than one sign=-1 reference")


def _validate_angle_mirror(angle_mask, angle_ij, angle_ik, angle_pair,
                           und_angle_ij, und_angle_ik,
                           und_angle_mask) -> None:
    """Angle-pair dedup invariant (mirrors ``_validate_mirror``).

    For every real angle t with p = angle_pair[t], (angle_ij, angle_ik)[t]
    equals the stored (und_angle_ij, und_angle_ik)[p] either same-oriented
    or swapped; each real dedup row is referenced by exactly one
    same-orientation angle and at most one swapped angle; und_angle_mask
    is a real-prefix indicator; padded angles carry pair=0.
    """
    na = int(angle_mask.sum())
    nu = int(und_angle_mask.sum())
    _check(
        np.all(und_angle_mask[:nu] == 1.0)
        and np.all(und_angle_mask[nu:] == 0.0),
        "und_angle_mask is not a real-prefix indicator")
    _check(np.all(angle_pair[na:] == 0),
           "padded angles must carry angle_pair=0")
    p = angle_pair[:na]
    _check(np.all((p >= 0) & (p < max(nu, 1))),
           "angle_pair out of range of the real dedup-angle prefix")
    same = (angle_ij[:na] == und_angle_ij[p]) \
        & (angle_ik[:na] == und_angle_ik[p])
    flip = (angle_ij[:na] == und_angle_ik[p]) \
        & (angle_ik[:na] == und_angle_ij[p])
    _check(np.all(same | flip),
           "an angle disagrees with its dedup row in both orientations")
    refs_same = np.bincount(p[same], minlength=nu)
    refs_flip = np.bincount(p[flip & ~same], minlength=nu)
    _check(np.all(refs_same == 1),
           "each dedup-angle row needs exactly one same-orientation ref")
    _check(np.all(refs_flip <= 1),
           "a dedup-angle row has more than one swapped reference")


def _validate_sym_incidence(bond_pair, und_angle_ij, und_angle_ik,
                            und_angle_mask, sym_dest, sym_rep,
                            sym_offsets) -> None:
    """Symmetric-trunk incidence invariant (DESIGN.md §10).

    The incidence store must be exactly the dest-sorted multiset
    { (bond_pair[und_angle_ij[w]], w), (bond_pair[und_angle_ik[w]], w) }
    over the real dedup-angle prefix — every real Au row appears exactly
    twice, once per undirected bond of its pair (both incidences may
    share a destination for self-image bonds i->i(±L)).  sym_offsets is
    the CSR of sym_dest over Eu rows with sym_offsets[-1] == 2·Au_real,
    and padded incidences carry (dest=0, rep=0) past the real prefix.
    """
    nua = int(und_angle_mask.sum())
    ni = 2 * nua
    _check(sym_dest.shape == sym_rep.shape,
           f"sym_dest/sym_rep shapes {sym_dest.shape} != {sym_rep.shape}")
    _check(ni <= sym_dest.shape[0],
           f"{ni} symmetric incidences exceed angle_cap {sym_dest.shape[0]}")
    _check(np.all(sym_dest[ni:] == 0) and np.all(sym_rep[ni:] == 0),
           "padded symmetric incidences must carry (dest=0, rep=0)")
    _check(np.all(np.diff(sym_dest[:ni]) >= 0),
           "real symmetric incidences not sorted by destination")
    _check(sym_offsets[0] == 0 and sym_offsets[-1] == ni,
           f"sym_offsets endpoints != (0, {ni})")
    _check(np.all(np.diff(sym_offsets) >= 0), "sym_offsets not monotone")
    expect = np.searchsorted(sym_dest[:ni], np.arange(sym_offsets.shape[0]))
    _check(np.array_equal(sym_offsets, expect),
           "sym_offsets disagree with sorted incidence destinations")
    want_dest = np.concatenate([bond_pair[und_angle_ij[:nua]],
                                bond_pair[und_angle_ik[:nua]]])
    want_rep = np.concatenate(
        [np.arange(nua, dtype=np.int64)] * 2) if nua else want_dest
    order = np.lexsort((want_rep, want_dest))
    have = np.lexsort((sym_rep[:ni], sym_dest[:ni]))
    _check(
        np.array_equal(sym_dest[:ni][have], want_dest[order])
        and np.array_equal(sym_rep[:ni][have], want_rep[order]),
        "symmetric incidences disagree with the dedup-angle mirror maps")


def atom_offsets(crystals: list[Crystal]) -> np.ndarray:
    """Start offset of each crystal's atoms in the packed atom axis."""
    return np.concatenate(
        [[0], np.cumsum([c.num_atoms for c in crystals])[:-1]]
    ).astype(np.int64)


def padding_waste(batch: CrystalGraphBatch) -> float:
    """Fraction of padded feature slots (atoms+bonds+angles) that are waste."""
    real = float(batch.atom_mask.sum() + batch.bond_mask.sum()
                 + batch.angle_mask.sum())
    cap = batch.atom_cap + batch.bond_cap + batch.angle_cap
    return 1.0 - real / cap if cap else 0.0
