"""Capacity policies for padded crystal-graph batches (host side).

The port keeps the JAX package's fixed-capacity padding: each batch is
packed into the smallest bucket of a ``CapacityLadder`` that fits it, so
the set of distinct batch shapes (and with it the per-shape step cache of
``repro_torch.batching.engine``) stays bounded by the ladder size.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _align_up(raw: int, align: int) -> int:
    return max(align, ((raw + align - 1) // align) * align)


@dataclasses.dataclass(frozen=True)
class BatchCapacities:
    """Static (atom, bond, angle) capacities of one padded batch.

    ``und_bonds`` caps the *undirected* half-graph store (DESIGN.md §5).
    ``None`` (the default) derives ``ceil(bonds / 2)`` — exact for the
    pair-symmetric graphs every uncapped producer emits (Eu == E/2).
    Graphs whose symmetry was broken by ``max_nbr_per_atom`` capping fall
    back to singleton undirected entries (Eu > E/2) and need an explicit
    ``und_bonds`` override to pack.

    ``und_angles`` likewise caps the angle-pair dedup store; ``None``
    derives ``ceil(angles / 2)`` — exact for the ordered angle lists
    ``_build_angles`` emits (each unordered pair appears twice, Au ==
    A/2); hand-built asymmetric angle lists need an override.
    """

    atoms: int
    bonds: int
    angles: int
    und_bonds: int | None = None
    und_angles: int | None = None

    @property
    def und_cap(self) -> int:
        """Undirected-bond capacity (``bonds``-derived unless overridden)."""
        if self.und_bonds is not None:
            return self.und_bonds
        return self.bonds // 2 + self.bonds % 2

    @property
    def und_angle_cap(self) -> int:
        """Dedup-angle capacity (``angles``-derived unless overridden)."""
        if self.und_angles is not None:
            return self.und_angles
        return self.angles // 2 + self.angles % 2

    def fits(
        self,
        n_atoms: int,
        n_bonds: int,
        n_angles: int,
        n_und_bonds: int | None = None,
        n_und_angles: int | None = None,
    ) -> bool:
        """True iff the counts fit; und counts are checked when given
        (producers with broken pair symmetry should pass them)."""
        return (
            n_atoms <= self.atoms
            and n_bonds <= self.bonds
            and n_angles <= self.angles
            and (n_und_bonds is None or n_und_bonds <= self.und_cap)
            and (n_und_angles is None or n_und_angles <= self.und_angle_cap)
        )

    @property
    def total(self) -> int:
        """Total padded feature slots (the paper's load metric, padded)."""
        return self.atoms + self.bonds + self.angles

    def scaled(self, k: int) -> "BatchCapacities":
        """Capacities for ``k`` structures that each fit this bucket."""
        return BatchCapacities(
            self.atoms * k, self.bonds * k, self.angles * k,
            None if self.und_bonds is None else self.und_bonds * k,
            None if self.und_angles is None else self.und_angles * k)


def capacity_from_stats(
    atoms: np.ndarray,
    bonds: np.ndarray,
    angles: np.ndarray,
    per_device_batch: int,
    *,
    quantile: float = 0.99,
    margin: float = 1.3,
    align: int = 256,
) -> BatchCapacities:
    """Single worst-case capacity at quantile + margin of per-sample stats."""

    def cap(x):
        q = float(np.quantile(x, quantile))
        return _align_up(int(q * per_device_batch * margin), align)

    return BatchCapacities(atoms=cap(atoms), bonds=cap(bonds),
                           angles=cap(angles))


def capacity_for(
    ds,
    per_device_batch: int,
    *,
    quantile: float = 0.99,
    margin: float = 1.3,
    align: int = 256,
) -> BatchCapacities:
    """Per-device capacities from the statistics of ``ds`` (any object with
    ``crystals`` / ``graphs`` lists, ``data.SyntheticDataset`` in
    practice)."""
    atoms = np.array([c.num_atoms for c in ds.crystals])
    bonds = np.array([g.num_bonds for g in ds.graphs])
    angles = np.array([g.num_angles for g in ds.graphs])
    return capacity_from_stats(
        atoms, bonds, angles, per_device_batch,
        quantile=quantile, margin=margin, align=align,
    )


@dataclasses.dataclass(frozen=True)
class CapacityLadder:
    """An ascending ladder of capacity buckets.

    ``bucket_for`` returns the smallest bucket that fits a batch; if even
    the top bucket is too small, an overflow bucket is synthesized by
    rounding each dimension up to ``align`` — selection therefore *never*
    truncates, it only costs one extra step-cache entry for the rare giant.
    """

    buckets: tuple[BatchCapacities, ...]
    align: int = 64

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("CapacityLadder needs at least one bucket")
        tot = [b.total for b in self.buckets]
        if sorted(tot) != tot:
            raise ValueError(f"buckets must ascend by total capacity: {tot}")

    def bucket_for(
        self, n_atoms: int, n_bonds: int, n_angles: int
    ) -> BatchCapacities:
        for b in self.buckets:
            if b.fits(n_atoms, n_bonds, n_angles):
                return b
        top = self.buckets[-1]
        bonds = _align_up(max(n_bonds, top.bonds), self.align)
        angles = _align_up(max(n_angles, top.angles), self.align)
        # explicit und overrides on the top bucket (asymmetric producers)
        # carry over, but never below the derived ceil(cap / 2) of the
        # *grown* bond/angle caps — overflow must not shrink headroom
        return BatchCapacities(
            atoms=_align_up(max(n_atoms, top.atoms), self.align),
            bonds=bonds,
            angles=angles,
            und_bonds=(None if top.und_bonds is None
                       else max(top.und_bonds, bonds // 2 + bonds % 2)),
            und_angles=(None if top.und_angles is None
                        else max(top.und_angles, angles // 2 + angles % 2)),
        )

    @property
    def top(self) -> BatchCapacities:
        return self.buckets[-1]


def ladder_from_stats(
    atoms: np.ndarray,
    bonds: np.ndarray,
    angles: np.ndarray,
    per_device_batch: int,
    *,
    num_buckets: int = 4,
    quantiles: tuple[float, ...] | None = None,
    margin: float = 1.3,
    align: int = 64,
) -> CapacityLadder:
    """Build a bucket ladder from per-sample size statistics.

    Bucket ``k`` is sized at quantile ``q_k`` of the per-sample stats times
    the batch size (plus margin); the top bucket uses the max so that any
    batch drawn from the dataset fits without the overflow path.
    """
    if quantiles is None:
        # evenly spaced interior quantiles in [0.5, 0.98]; the top bucket
        # (max-based) is added below, so num_buckets - 1 interior ones
        k = max(0, num_buckets - 1)
        quantiles = tuple(np.linspace(0.5, 0.98, k)) if k else ()

    def cap_at(x, q):
        return _align_up(
            int(float(np.quantile(x, q)) * per_device_batch * margin), align
        )

    buckets = []
    for q in quantiles:
        buckets.append(BatchCapacities(
            atoms=cap_at(atoms, q), bonds=cap_at(bonds, q),
            angles=cap_at(angles, q),
        ))
    # top bucket: fits any batch of per_device_batch samples, with the
    # same margin headroom as the interior buckets (serving callers rely
    # on it for MD size drift)
    buckets.append(BatchCapacities(
        atoms=_align_up(int(np.ceil(atoms.max() * margin)) * per_device_batch,
                        align),
        bonds=_align_up(int(np.ceil(bonds.max() * margin)) * per_device_batch,
                        align),
        angles=_align_up(int(np.ceil(angles.max() * margin)) * per_device_batch,
                         align),
    ))
    # enforce per-dimension monotonicity (the final bucket dominates every
    # earlier one, so "top fits any batch" survives), then deduplicate
    kept: list[BatchCapacities] = []
    for b in buckets:
        if kept:
            prev = kept[-1]
            b = BatchCapacities(
                atoms=max(b.atoms, prev.atoms),
                bonds=max(b.bonds, prev.bonds),
                angles=max(b.angles, prev.angles),
            )
            if (b.atoms, b.bonds, b.angles) == (
                    prev.atoms, prev.bonds, prev.angles):
                continue
        kept.append(b)
    return CapacityLadder(buckets=tuple(kept), align=align)


def ladder_for(
    ds,
    per_device_batch: int,
    *,
    num_buckets: int = 4,
    margin: float = 1.3,
    align: int = 64,
) -> CapacityLadder:
    """Bucket ladder sized from dataset statistics (see ``ladder_from_stats``)."""
    atoms = np.array([c.num_atoms for c in ds.crystals])
    bonds = np.array([g.num_bonds for g in ds.graphs])
    angles = np.array([g.num_angles for g in ds.graphs])
    return ladder_from_stats(
        atoms, bonds, angles, per_device_batch,
        num_buckets=num_buckets, margin=margin, align=align,
    )
