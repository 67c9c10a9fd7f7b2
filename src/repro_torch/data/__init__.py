"""Synthetic labelled data, samplers and the batch iterator of the port."""
from .pipeline import BatchIterator, build_device_batch
from .sampler import DefaultSampler, LoadBalanceSampler
from .synthetic import (
    SyntheticConfig,
    SyntheticDataset,
    generate_crystal,
    label_crystal,
    make_dataset,
)

__all__ = [
    "BatchIterator", "build_device_batch",
    "DefaultSampler", "LoadBalanceSampler",
    "SyntheticConfig", "SyntheticDataset", "generate_crystal",
    "label_crystal", "make_dataset",
]
