"""Gradient transformations, PyTorch port of part of ``repro.optim.grad``:
the global norm, the global-norm clip (with the JAX package's
``norm + 1e-12``, not ``torch.nn.utils.clip_grad_norm_``'s epsilon), the
all-finite check and the loss scaler's unscale.  The compressed all-reduce (``compress``, ``ef_init``)
comes with multi-GPU training, ROADMAP 'Modules to port' item 13.

Each function takes a tree (a list of leaves is one).  Nothing here
reads a device value back to the host.
"""
from __future__ import annotations

import torch

from .tree import leaves, unflatten


def tree_all_finite(tree) -> torch.Tensor:
    """Scalar bool tensor: every element of every leaf is finite."""
    flat = leaves(tree)
    if not flat:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(x).all() for x in flat]).all()


def unscale_grads(grads, scale) -> list:
    """Undo loss scaling and upcast to f32, before the clip, so that the
    clip threshold is in true-gradient units (DESIGN.md §4).  ``scale`` is
    a 0-d tensor (a CPU one multiplies a tensor on any device)."""
    inv = 1.0 / torch.as_tensor(scale, dtype=torch.float32)
    return [g.float() * inv for g in leaves(grads)]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every element of every leaf (per-leaf
    norms first: a few multi-tensor launches, not one per leaf)."""
    flat = [x.float() for x in leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(flat)))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf by min(1, max_norm / (norm + 1e-12))."""
    flat = leaves(tree)
    norm = global_norm(flat)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return unflatten(tree, torch._foreach_mul(flat, scale))
