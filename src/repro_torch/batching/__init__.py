"""Host-side batching for the PyTorch port: capacity ladders, packing into
the sorted-CSR layout, and the per-shape step cache."""
from .capacity import (
    BatchCapacities,
    CapacityLadder,
    capacity_for,
    capacity_from_stats,
    ladder_for,
    ladder_from_stats,
)
from .engine import BatchingEngine, StepCache
from .pack import atom_offsets, batch_crystals, padding_waste, validate_layout

__all__ = [
    "BatchCapacities", "CapacityLadder", "capacity_for",
    "capacity_from_stats", "ladder_for", "ladder_from_stats",
    "BatchingEngine", "StepCache",
    "atom_offsets", "batch_crystals", "padding_waste", "validate_layout",
]
