"""Synthetic labelled data, samplers, the batch iterator and the
prefetcher of the port.  ``capacity_for`` / ``ladder_for`` (capacity
policy, ``repro_torch.batching``) are re-exported here, as in
``repro.data``."""
from repro_torch.batching import capacity_for, ladder_for
from repro_torch.runtime.fault import TransientSampleError

from .pipeline import (
    BalancedBatchIterator,
    BatchIterator,
    Prefetcher,
    TaggedBatch,
    build_device_batch,
)
from .sampler import (
    CostBalanceSampler,
    DefaultSampler,
    LoadBalanceSampler,
    cov_of_device_loads,
    device_loads,
)
from .synthetic import (
    SyntheticConfig,
    SyntheticDataset,
    generate_crystal,
    label_crystal,
    make_dataset,
)

__all__ = [
    "BalancedBatchIterator", "BatchIterator", "Prefetcher", "TaggedBatch",
    "TransientSampleError", "build_device_batch", "capacity_for",
    "ladder_for", "CostBalanceSampler", "DefaultSampler",
    "LoadBalanceSampler", "cov_of_device_loads", "device_loads",
    "SyntheticConfig", "SyntheticDataset", "generate_crystal",
    "label_crystal", "make_dataset",
]
