"""Data parallelism of the PyTorch port over ``torch.distributed``
(DESIGN.md §6): the mesh and the collectives of the DP steps."""
from .collectives import (
    GRAD_REDUCE, all_reduce_grads, bucket_plan, bucketed_all_reduce,
    compressed_all_reduce, mean_metrics, stack_over_ranks, sum_scalars,
)
from .mesh import DataMesh, init_data_mesh

__all__ = [
    "GRAD_REDUCE", "all_reduce_grads", "bucket_plan", "bucketed_all_reduce",
    "compressed_all_reduce", "mean_metrics", "stack_over_ranks",
    "sum_scalars", "DataMesh", "init_data_mesh",
]
