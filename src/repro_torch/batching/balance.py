"""Cost-model bin-packing sharder + microbatch planning (DESIGN.md §6),
a copy of ``repro.batching.balance`` (numpy only: the same costs give the
JAX package's plans bit for bit).

Replaces "split the sampler's batch evenly by count" DP sharding with
Longest-Processing-Time (LPT) bin packing over predicted per-crystal
costs (``repro.batching.cost``):

  - :func:`lpt_pack`: deterministic greedy LPT — items sorted by cost
    descending (index tiebreak), each assigned to the least-loaded bin.
    Classic 4/3-approximation of makespan; with >= num_bins items every
    bin is non-empty.
  - :func:`plan_microbatches`: splits one global batch into ``num_micro``
    *size-homogeneous* chunks (sorted by cost, contiguous slices) and
    LPT-packs each chunk across devices.  Homogeneous chunks are what
    lets each microbatch pick a *small* capacity bucket: the big-crystal
    microbatch pays the big bucket, the small-crystal ones don't — the
    gradient-accumulation path (train.trainer) then sums the per-bucket
    microbatch grads, so nothing is padded to the worst bucket.
  - :class:`StepPlan`: the packed per-step product consumed by
    ``Trainer`` — microbatches (one CPU ``CrystalGraphBatch`` per bucket
    group; the Prefetcher may hand them over on the card), global loss
    denominators, and the predicted shard costs (the straggler view).

Invariants (relied on by tests and the trainer):
  - packing is a pure function of (costs, num_bins, max_items) — same
    inputs give the same assignment on every host/process;
  - every device bin of every microbatch has <= ``max_items`` items, so
    the padded crystal-slot axis is a static shape per (global_batch,
    num_micro, num_devices) and the number of step shapes stays bounded;
  - the union of all bins is exactly the input index set (nothing
    dropped, nothing duplicated).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = [
    "StepPlan", "lpt_pack", "plan_microbatches", "shard_cost_totals",
    "straggler_ratio", "crystal_slots_for",
]


def lpt_pack(
    costs: np.ndarray,
    num_bins: int,
    *,
    max_items: int | None = None,
) -> list[np.ndarray]:
    """Greedy LPT: sort by cost descending, assign to least-loaded bin.

    Returns ``num_bins`` index arrays (positions into ``costs``), each
    sorted ascending for stable downstream packing.  Deterministic: ties
    in cost break by original position, ties in load break by bin index.
    ``max_items`` caps the item count per bin (full bins are skipped), so
    a pile of near-zero-cost items cannot blow past the padded
    crystal-slot capacity; it must satisfy
    ``max_items * num_bins >= len(costs)``.
    """
    costs = np.asarray(costs, np.float64)
    n = costs.shape[0]
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")
    if max_items is not None and max_items * num_bins < n:
        raise ValueError(
            f"max_items {max_items} x {num_bins} bins < {n} items")
    # stable descending order: negate costs so argsort's ascending order
    # with index tiebreak gives (cost desc, position asc)
    order = np.argsort(-costs, kind="stable")
    loads = np.zeros(num_bins, np.float64)
    counts = np.zeros(num_bins, np.int64)
    bins: list[list[int]] = [[] for _ in range(num_bins)]
    for pos in order:
        if max_items is not None:
            open_bins = counts < max_items
            # argmin over loads with full bins masked to +inf; ties pick
            # the lowest bin index (np.argmin's first-occurrence rule)
            masked = np.where(open_bins, loads, np.inf)
        else:
            masked = loads
        b = int(np.argmin(masked))
        bins[b].append(int(pos))
        loads[b] += costs[pos]
        counts[b] += 1
    return [np.sort(np.asarray(b, np.int64)) for b in bins]


def plan_microbatches(
    costs: np.ndarray,
    num_devices: int,
    num_micro: int = 1,
    *,
    max_items: int | None = None,
) -> list[list[np.ndarray]]:
    """Partition one global batch into ``num_micro`` x ``num_devices``
    balanced bins.

    Items are sorted by cost descending and cut into ``num_micro``
    contiguous chunks (near-equal counts, remainder to the earlier =
    costlier chunks), then each chunk is LPT-packed across devices.  The
    sort makes chunks size-homogeneous, so each microbatch's shards fit a
    *small* capacity bucket; LPT inside a chunk keeps the per-device
    makespan tight, which is what sets the step time.

    Returns positions into ``costs``: ``plan[m][d]`` is device ``d``'s
    item set of microbatch ``m``.  Microbatches with fewer items than
    devices leave the trailing device bins empty (the accumulation step
    runs them as all-padding shards whose loss/grad sums are exactly
    zero).  Batches with fewer than ``num_micro * num_devices`` items get
    fewer (non-empty) microbatches instead.
    """
    costs = np.asarray(costs, np.float64)
    n = costs.shape[0]
    if num_micro < 1:
        raise ValueError(f"num_micro must be >= 1, got {num_micro}")
    num_micro = max(1, min(num_micro, n // max(num_devices, 1)) or 1)
    order = np.argsort(-costs, kind="stable")
    base, rem = divmod(n, num_micro)
    plan: list[list[np.ndarray]] = []
    start = 0
    for m in range(num_micro):
        size = base + (1 if m < rem else 0)
        chunk = order[start:start + size]
        start += size
        if chunk.size == 0:
            continue
        shards = lpt_pack(costs[chunk], num_devices, max_items=max_items)
        plan.append([chunk[s] for s in shards])
    return plan


def crystal_slots_for(global_batch: int, num_devices: int,
                      num_micro: int = 1) -> int:
    """Static crystal-slot capacity per device shard.

    LPT needs headroom beyond ``ceil(chunk / devices)`` to trade a big
    crystal on one device against several small ones on another; 2x is
    enough for any assignment LPT produces under this cap while keeping
    the padded crystal axis a fixed shape.
    """
    chunk = -(-global_batch // max(num_micro, 1))
    return min(chunk, 2 * -(-chunk // max(num_devices, 1)))


def shard_cost_totals(costs: np.ndarray,
                      shards: list[np.ndarray]) -> np.ndarray:
    """Total predicted cost per shard (the balancer's makespan view)."""
    return np.array([float(np.sum(costs[s])) for s in shards], np.float64)


def straggler_ratio(shard_costs: np.ndarray) -> float:
    """max/mean shard cost: 1.0 = perfectly balanced, the step-time
    multiplier the slowest shard imposes on the mesh otherwise."""
    shard_costs = np.asarray(shard_costs, np.float64)
    mean = float(np.mean(shard_costs))
    if mean <= 0.0:
        return 1.0
    return float(np.max(shard_costs)) / mean


@dataclasses.dataclass
class StepPlan:
    """One optimizer step's worth of balanced, bucketed microbatches.

    ``micro``: packed batches, one per bucket group; ``denoms``: the
    GLOBAL loss denominators (``repro_torch.core.losses.chgnet_loss_sums``)
    that make the accumulated gradient exactly equal a single big-batch
    gradient; ``shard_costs``:
    (num_micro, num_devices) predicted costs for straggler reporting;
    ``num_real``: real crystals in the step (throughput accounting).
    """

    micro: list[Any]
    denoms: dict[str, np.ndarray]
    shard_costs: np.ndarray
    num_real: int = 0
    # (num_micro, 3) REAL atom/bond/angle totals per microbatch, filled by
    # BalancedBatchIterator.plan_step — the feature columns that pair with
    # the Trainer's measured per-microbatch wall times when it refits the
    # cost model live (cost.fit_cost_model); None when the producer does
    # not track sizes
    micro_sizes: np.ndarray | None = None

    @property
    def straggler(self) -> float:
        """max/mean predicted cost across all device shards of the step,
        treating microbatches as sequential phases (costs sum per device)."""
        per_device = self.shard_costs.sum(axis=0)
        return straggler_ratio(per_device)
