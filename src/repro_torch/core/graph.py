"""Padded, fixed-shape crystal-graph batches as torch tensors.

Mirrors ``repro.core.graph.CrystalGraphBatch`` field for field (35
fields), with the same padding and sorted-segment conventions:

  - real entries are packed at the front, masks mark validity;
  - padded bonds/angles point at slot 0 with zeroed (masked) payloads;
  - real bonds are sorted by ``bond_center`` and real angles by
    ``angle_ij``, with CSR row pointers ``bond_offsets`` /
    ``angle_offsets`` whose last entry is the real-entry count, so the
    padded tail lies outside every row (DESIGN.md §1).

Ids stay int32, as the packer emits them; torch ops that need int64
indices cast at the use site.  Host-side packing lives in
``repro_torch.batching``; a batch is built on the CPU and moved to the
card with ``.to(device)`` (or ``.pin_memory().to(device, non_blocking=
True)``, as ``data.Prefetcher`` does).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

FIELDS = (
    "atom_z", "atom_mask", "atom_crystal", "frac_coords", "lattice",
    "crystal_mask", "bond_center", "bond_nbr", "bond_image",
    "bond_crystal", "bond_mask", "angle_ij", "angle_ik", "angle_mask",
    "bond_offsets", "angle_offsets",
    "bond_pair", "bond_sign", "und_center", "und_nbr", "und_image",
    "und_crystal", "und_mask",
    "angle_pair", "und_angle_ij", "und_angle_ik", "und_angle_mask",
    "sym_dest", "sym_rep", "sym_offsets",
    "energy", "forces", "stress", "magmoms", "n_atoms_per_crystal",
)


@dataclasses.dataclass
class CrystalGraphBatch:
    """A padded batch of B crystals, flattened atoms/bonds/angles."""

    # atoms
    atom_z: torch.Tensor         # (atom_cap,) int32; 0 for padding
    atom_mask: torch.Tensor      # (atom_cap,) f32
    atom_crystal: torch.Tensor   # (atom_cap,) int32 crystal id in [0, B)
    frac_coords: torch.Tensor    # (atom_cap, 3) f32
    # crystals
    lattice: torch.Tensor        # (B, 3, 3) f32
    crystal_mask: torch.Tensor   # (B,) f32
    # bonds (directed; G^a edges)
    bond_center: torch.Tensor    # (bond_cap,) int32 -> atom index
    bond_nbr: torch.Tensor       # (bond_cap,) int32 -> atom index
    bond_image: torch.Tensor     # (bond_cap, 3) f32 periodic image
    bond_crystal: torch.Tensor   # (bond_cap,) int32
    bond_mask: torch.Tensor      # (bond_cap,) f32
    # angles (G^b edges): indices into bonds
    angle_ij: torch.Tensor       # (angle_cap,) int32
    angle_ik: torch.Tensor       # (angle_cap,) int32
    angle_mask: torch.Tensor     # (angle_cap,) f32
    # CSR row pointers of the sorted-segment layout (DESIGN.md §1)
    bond_offsets: torch.Tensor   # (atom_cap + 1,) int32
    angle_offsets: torch.Tensor  # (bond_cap + 1,) int32
    # undirected half-graph store (DESIGN.md §5)
    bond_pair: torch.Tensor      # (bond_cap,) int32 -> undirected index
    bond_sign: torch.Tensor      # (bond_cap,) f32 ±1 (0 on padding)
    und_center: torch.Tensor     # (und_cap,) int32 -> atom index
    und_nbr: torch.Tensor        # (und_cap,) int32 -> atom index
    und_image: torch.Tensor      # (und_cap, 3) f32 periodic image
    und_crystal: torch.Tensor    # (und_cap,) int32
    und_mask: torch.Tensor       # (und_cap,) f32
    # angle-pair dedup store
    angle_pair: torch.Tensor     # (angle_cap,) int32 -> und angle index
    und_angle_ij: torch.Tensor   # (und_angle_cap,) int32 -> bond index
    und_angle_ik: torch.Tensor   # (und_angle_cap,) int32 -> bond index
    und_angle_mask: torch.Tensor  # (und_angle_cap,) f32
    # symmetric-trunk incidence store (DESIGN.md §10)
    sym_dest: torch.Tensor       # (angle_cap,) int32 -> und bond index
    sym_rep: torch.Tensor        # (angle_cap,) int32 -> und angle index
    sym_offsets: torch.Tensor    # (und_cap + 1,) int32 CSR row pointers
    # labels
    energy: torch.Tensor         # (B,) f32 total energy (eV)
    forces: torch.Tensor         # (atom_cap, 3) f32
    stress: torch.Tensor         # (B, 3, 3) f32
    magmoms: torch.Tensor        # (atom_cap,) f32
    n_atoms_per_crystal: torch.Tensor  # (B,) f32

    @classmethod
    def from_numpy(cls, mapping: Mapping[str, np.ndarray]) -> "CrystalGraphBatch":
        """Wrap host arrays (no copy) as a CPU batch; needs all 35 fields."""
        missing = set(FIELDS) - set(mapping)
        if missing:
            raise ValueError(f"missing batch fields: {sorted(missing)}")
        return cls(**{k: torch.from_numpy(np.ascontiguousarray(mapping[k]))
                      for k in FIELDS})

    def to(self, device, non_blocking: bool = False) -> "CrystalGraphBatch":
        """Every field on ``device``; ``non_blocking`` copies from pinned
        host memory run asynchronously on the current stream."""
        return CrystalGraphBatch(**{
            k: getattr(self, k).to(device, non_blocking=non_blocking)
            for k in FIELDS})

    def pin_memory(self) -> "CrystalGraphBatch":
        """A copy of this CPU batch in page-locked host memory, the source
        of asynchronous copies to the card (needs CUDA)."""
        return CrystalGraphBatch(**{k: getattr(self, k).pin_memory()
                                    for k in FIELDS})

    def record_stream(self, stream) -> None:
        """Mark every field's memory as in use on ``stream`` (CUDA batches
        made on another stream), so that the caching allocator does not
        hand it out again before ``stream``'s work on it is done."""
        for k in FIELDS:
            getattr(self, k).record_stream(stream)

    def numpy(self) -> dict[str, np.ndarray]:
        """Host copies of every field, keyed by name."""
        return {k: getattr(self, k).cpu().numpy() for k in FIELDS}

    @property
    def num_crystals(self) -> int:
        return self.lattice.shape[0]

    @property
    def atom_cap(self) -> int:
        return self.atom_z.shape[0]

    @property
    def bond_cap(self) -> int:
        return self.bond_center.shape[0]

    @property
    def angle_cap(self) -> int:
        return self.angle_ij.shape[0]

    @property
    def und_cap(self) -> int:
        return self.und_center.shape[0]

    @property
    def und_angle_cap(self) -> int:
        return self.und_angle_ij.shape[0]


def batch_input_specs(batch_size: int, caps, dtype=torch.float32
                      ) -> CrystalGraphBatch:
    """A stand-in batch of ``meta`` tensors (shapes and dtypes, no
    storage) for the dry run, as ``repro.core.graph.batch_input_specs``;
    ``caps`` a ``batching.BatchCapacities``."""
    f, i = dtype, torch.int32
    a, e, g = caps.atoms, caps.bonds, caps.angles
    eu, au = caps.und_cap, caps.und_angle_cap
    shapes = {
        "atom_z": ((a,), i), "atom_mask": ((a,), f),
        "atom_crystal": ((a,), i), "frac_coords": ((a, 3), f),
        "lattice": ((batch_size, 3, 3), f),
        "crystal_mask": ((batch_size,), f),
        "bond_center": ((e,), i), "bond_nbr": ((e,), i),
        "bond_image": ((e, 3), f), "bond_crystal": ((e,), i),
        "bond_mask": ((e,), f),
        "angle_ij": ((g,), i), "angle_ik": ((g,), i),
        "angle_mask": ((g,), f),
        "bond_offsets": ((a + 1,), i), "angle_offsets": ((e + 1,), i),
        "bond_pair": ((e,), i), "bond_sign": ((e,), f),
        "und_center": ((eu,), i), "und_nbr": ((eu,), i),
        "und_image": ((eu, 3), f), "und_crystal": ((eu,), i),
        "und_mask": ((eu,), f),
        "angle_pair": ((g,), i), "und_angle_ij": ((au,), i),
        "und_angle_ik": ((au,), i), "und_angle_mask": ((au,), f),
        "sym_dest": ((g,), i), "sym_rep": ((g,), i),
        "sym_offsets": ((eu + 1,), i),
        "energy": ((batch_size,), f), "forces": ((a, 3), f),
        "stress": ((batch_size, 3, 3), f), "magmoms": ((a,), f),
        "n_atoms_per_crystal": ((batch_size,), f),
    }
    return CrystalGraphBatch(**{
        k: torch.empty(s, dtype=t, device="meta")
        for k, (s, t) in shapes.items()})
