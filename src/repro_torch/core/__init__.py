"""Core CHGNet / FastCHGNet model of the PyTorch port."""
from .chgnet import CHGNet, CHGNetConfig, chgnet_apply, chgnet_init
from .graph import CrystalGraphBatch
from .neighbors import Crystal, GraphIndices, VerletNeighborList, build_graph

__all__ = [
    "CHGNet", "CHGNetConfig", "chgnet_apply", "chgnet_init",
    "CrystalGraphBatch",
    "Crystal", "GraphIndices", "VerletNeighborList", "build_graph",
]
