"""Training-side batch iteration, PyTorch port of the single-device part
of ``repro.data.pipeline``.

``BatchIterator`` draws global batches from a sampler (paper C6) and
packs each into one padded CPU ``CrystalGraphBatch`` with
``batching.batch_crystals``: into a fixed ``BatchCapacities``, or into the
smallest bucket of a ``CapacityLadder`` that fits.  The caller moves the
batch to the card (``Trainer`` does).  Multi-device sharding, the cost
balancer, ``BalancedBatchIterator`` and the ``Prefetcher`` come with
ROADMAP 'Modules to port' item 9 and raise here.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.batching import BatchCapacities, CapacityLadder, batch_crystals
from repro_torch.core.graph import CrystalGraphBatch
from .sampler import DefaultSampler, LoadBalanceSampler
from .synthetic import SyntheticDataset

_TODO = "is not ported yet: ROADMAP 'Modules to port' item 9"


def build_device_batch(
    ds: SyntheticDataset,
    indices: np.ndarray,
    caps: BatchCapacities,
    *,
    num_crystal_slots: int | None = None,
    validate: bool = True,
) -> CrystalGraphBatch:
    return batch_crystals(
        [ds.crystals[i] for i in indices],
        [ds.graphs[i] for i in indices],
        caps,
        num_crystal_slots=num_crystal_slots,
        validate=validate,
    )


class BatchIterator:
    """Epoch iterator producing padded single-device CPU batches."""

    def __init__(
        self,
        ds: SyntheticDataset,
        global_batch: int,
        num_devices: int,
        caps: BatchCapacities | CapacityLadder,
        *,
        load_balance: bool | str = True,
        seed: int = 0,
        drop_last: bool = True,
        validate_layout: bool = True,
    ):
        if num_devices != 1:
            raise NotImplementedError(f"num_devices={num_devices} {_TODO}")
        if load_balance == "cost":
            raise NotImplementedError(f'load_balance="cost" {_TODO}')
        if global_batch < num_devices:
            raise ValueError(
                f"global_batch {global_batch} < num_devices {num_devices}")
        self.ds = ds
        self.global_batch = global_batch
        self.num_devices = num_devices
        self.caps = caps
        self.drop_last = drop_last
        self.validate_layout = validate_layout
        self.crystal_slots = math.ceil(global_batch / num_devices)
        counts = ds.feature_counts()
        self.sampler = (LoadBalanceSampler(counts, seed) if load_balance
                        else DefaultSampler(counts, seed))

    def _caps_for(self, shards: list[np.ndarray]) -> BatchCapacities:
        if isinstance(self.caps, BatchCapacities):
            return self.caps
        na = nb = ng = 0
        for s in shards:
            na = max(na, sum(self.ds.crystals[i].num_atoms for i in s))
            nb = max(nb, sum(self.ds.graphs[i].num_bonds for i in s))
            ng = max(ng, sum(self.ds.graphs[i].num_angles for i in s))
        return self.caps.bucket_for(na, nb, ng)

    def __iter__(self):
        for _idx, shards in self.sampler.epoch(
                self.global_batch, self.num_devices,
                drop_last=self.drop_last):
            (shard,) = shards
            yield build_device_batch(
                self.ds, shard, self._caps_for(shards),
                num_crystal_slots=self.crystal_slots,
                validate=self.validate_layout)


class BalancedBatchIterator:
    """The cost-balanced microbatch iterator (DESIGN.md §6)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"BalancedBatchIterator {_TODO}")


class Prefetcher:
    """The background batch prefetcher (paper C8)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"Prefetcher {_TODO}")
