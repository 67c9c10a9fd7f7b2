"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``) and the wrappers that choose between them by device (``ops``).
The kernels are built from ``repro_torch/csrc`` at first use
(``build``), never at import."""
from . import ops, ref

__all__ = ["ops", "ref"]
