"""Synthetic labelled data, samplers, the batch iterator and the
prefetcher of the port.  ``capacity_for`` / ``ladder_for`` (capacity
policy, ``repro_torch.batching``) are re-exported here, as in
``repro.data``."""
from repro_torch.batching import capacity_for, ladder_for
from repro_torch.runtime.fault import TransientSampleError

from .pipeline import BatchIterator, Prefetcher, build_device_batch
from .sampler import DefaultSampler, LoadBalanceSampler
from .synthetic import (
    SyntheticConfig,
    SyntheticDataset,
    generate_crystal,
    label_crystal,
    make_dataset,
)

__all__ = [
    "BatchIterator", "Prefetcher", "TransientSampleError",
    "build_device_batch", "capacity_for", "ladder_for",
    "DefaultSampler", "LoadBalanceSampler",
    "SyntheticConfig", "SyntheticDataset", "generate_crystal",
    "label_crystal", "make_dataset",
]
