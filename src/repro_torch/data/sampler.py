"""Batch samplers, including the paper's Load Balance Sampler (C6, Fig. 4),
PyTorch port of ``repro.data.sampler`` (plain numpy, so the same seed
gives the JAX package's batches).

The load metric of a sample is its feature count = atoms + bonds + angles
(paper Fig. 9).  ``LoadBalanceSampler`` sorts a global batch by feature
count, pairs the smallest remaining sample with the largest and deals
the pairs to devices round-robin.  The cost-model sampler of DESIGN.md §6
comes with multi-GPU training (ROADMAP 'Modules to port' item 13).
"""
from __future__ import annotations

import numpy as np


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
