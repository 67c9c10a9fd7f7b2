"""Batch samplers, including the paper's Load Balance Sampler (C6, Fig. 4),
PyTorch port of ``repro.data.sampler`` (plain numpy, so the same seed
gives the JAX package's batches).

The load metric of a sample is its feature count = atoms + bonds + angles
(paper Fig. 9).  ``LoadBalanceSampler`` sorts a global batch by feature
count, pairs the smallest remaining sample with the largest and deals
the pairs to devices round-robin.  Imbalance across the per-device shards
is measured by the coefficient of variation (CoV) of their totals
(``cov_of_device_loads``).  ``CostBalanceSampler`` (DESIGN.md §6) packs
shards by LPT over a per-crystal cost model (``batching.cost``) instead
of equal counts: shards may hold different numbers of samples, but their
predicted step costs are tight.
"""
from __future__ import annotations

import numpy as np

from repro_torch.batching.balance import lpt_pack


def _validate_batch(batch_size: int, num_devices: int) -> None:
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if batch_size < num_devices:
        raise ValueError(
            f"batch_size {batch_size} < num_devices {num_devices}: "
            "every device needs at least one sample"
        )


def _epoch_slices(n: int, batch_size: int, num_devices: int,
                  drop_last: bool):
    """Start/stop of each global batch; optionally the tail remainder,
    when it can give every device at least one sample."""
    full_end = (n // batch_size) * batch_size
    for s in range(0, full_end, batch_size):
        yield s, s + batch_size
    if not drop_last and n - full_end >= num_devices:
        yield full_end, n


def cov_of_device_loads(loads: np.ndarray) -> float:
    """Coefficient of variation of per-device load totals."""
    mu = float(np.mean(loads))
    if mu == 0.0:
        return 0.0
    return float(np.std(loads) / mu)


class DefaultSampler:
    """Random global batches, contiguous split across devices (reference)."""

    def __init__(self, feature_counts: np.ndarray, seed: int = 0):
        self.counts = np.asarray(feature_counts)
        self.rng = np.random.default_rng(seed)

    def epoch(self, batch_size: int, num_devices: int, *,
              drop_last: bool = True):
        """Yields (global_indices, per_device_index_lists); shard lengths
        differ by at most one."""
        _validate_batch(batch_size, num_devices)
        n = self.counts.shape[0]
        perm = self.rng.permutation(n)
        for s, e in _epoch_slices(n, batch_size, num_devices, drop_last):
            idx = perm[s:e]
            yield idx, np.array_split(idx, num_devices)


class LoadBalanceSampler:
    """Paper Fig. 4: smallest+largest pairing, dealt round-robin."""

    def __init__(self, feature_counts: np.ndarray, seed: int = 0):
        self.counts = np.asarray(feature_counts)
        self.rng = np.random.default_rng(seed)

    def assign(self, idx: np.ndarray, num_devices: int) -> list[np.ndarray]:
        """Split one global batch's indices across devices, balanced: every
        shard gets floor or ceil of ``len(idx) / num_devices`` samples."""
        order = np.argsort(self.counts[idx], kind="stable")
        sorted_idx = idx[order]
        base, rem = divmod(len(sorted_idx), num_devices)
        targets = [base + (1 if d < rem else 0) for d in range(num_devices)]
        lo, hi = 0, len(sorted_idx) - 1
        shards: list[list[int]] = [[] for _ in range(num_devices)]
        d = 0
        while lo <= hi:
            while len(shards[d]) >= targets[d]:
                d = (d + 1) % num_devices
            shards[d].append(sorted_idx[lo])
            lo += 1
            if lo <= hi and len(shards[d]) < targets[d]:
                shards[d].append(sorted_idx[hi])
                hi -= 1
            d = (d + 1) % num_devices
        return [np.asarray(s, dtype=np.int64) for s in shards]

    def epoch(self, batch_size: int, num_devices: int, *,
              drop_last: bool = True):
        """Like ``DefaultSampler.epoch``, balanced."""
        _validate_batch(batch_size, num_devices)
        n = self.counts.shape[0]
        perm = self.rng.permutation(n)
        for s, e in _epoch_slices(n, batch_size, num_devices, drop_last):
            idx = perm[s:e]
            yield idx, self.assign(idx, num_devices)


class CostBalanceSampler:
    """LPT bin packing over predicted per-crystal costs (DESIGN.md §6).

    Shards may hold *different sample counts*; ``max_items`` caps the
    per-shard count so that packing can pad every shard to a static
    number of crystal slots (``batching.balance.crystal_slots_for``).
    """

    def __init__(self, costs: np.ndarray, seed: int = 0,
                 max_items: int | None = None):
        self.counts = np.asarray(costs, np.float64)  # sampler-API name
        self.rng = np.random.default_rng(seed)
        self.max_items = max_items

    def assign(self, idx: np.ndarray, num_devices: int) -> list[np.ndarray]:
        shards = lpt_pack(self.counts[idx], num_devices,
                          max_items=self.max_items)
        return [np.asarray(idx)[s] for s in shards]

    def epoch(self, batch_size: int, num_devices: int, *,
              drop_last: bool = True):
        """Same contract as the other samplers: (global_idx, shards)."""
        _validate_batch(batch_size, num_devices)
        n = self.counts.shape[0]
        perm = self.rng.permutation(n)
        for s, e in _epoch_slices(n, batch_size, num_devices, drop_last):
            idx = perm[s:e]
            yield idx, self.assign(idx, num_devices)


def device_loads(counts: np.ndarray, shards: list[np.ndarray]) -> np.ndarray:
    return np.array([counts[s].sum() for s in shards], dtype=np.float64)
