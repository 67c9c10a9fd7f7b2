"""Host-side batching for the PyTorch port: capacity ladders, packing into
the sorted-CSR layout, the per-shape step cache, and the cost model and
bin packing of the load balancer (DESIGN.md §6)."""
from .balance import (
    StepPlan,
    crystal_slots_for,
    lpt_pack,
    plan_microbatches,
    shard_cost_totals,
    straggler_ratio,
)
from .capacity import (
    BatchCapacities,
    CapacityLadder,
    capacity_for,
    capacity_from_stats,
    ladder_for,
    ladder_from_stats,
)
from .cost import DEFAULT_COST_MODEL, CostModel, fit_cost_model
from .engine import BatchingEngine, StepCache
from .pack import atom_offsets, batch_crystals, padding_waste, validate_layout

__all__ = [
    "StepPlan", "crystal_slots_for", "lpt_pack", "plan_microbatches",
    "shard_cost_totals", "straggler_ratio",
    "DEFAULT_COST_MODEL", "CostModel", "fit_cost_model",
    "BatchCapacities", "CapacityLadder", "capacity_for",
    "capacity_from_stats", "ladder_for", "ladder_from_stats",
    "BatchingEngine", "StepCache",
    "atom_offsets", "batch_crystals", "padding_waste", "validate_layout",
]
