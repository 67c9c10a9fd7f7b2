"""Gradient transformations, PyTorch port of ``repro.optim.grad``: the
global norm, the global-norm clip (with the JAX package's ``norm +
1e-12``, not ``torch.nn.utils.clip_grad_norm_``'s epsilon), the
all-finite check, the loss scaler's unscale, and the bf16 compression of
the cross-device all-reduce (``compress`` / ``decompress``, with an
error-feedback state from ``ef_init`` that re-injects the rounding error
next step).

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


def ef_init(params):
    """Error-feedback residual state: zeros like every leaf, as a tree of
    ``params``'s structure."""
    return unflatten(params, [torch.zeros_like(x) for x in leaves(params)])


@torch.no_grad()
def compress(grads, ef_state=None):
    """Round the gradients to bf16, after adding the error-feedback
    residual when ``ef_state`` is given.  Returns ``(q, new_ef)``: the bf16
    leaves and the new residual (``g - q`` in ``g``'s dtype; ``None``
    without a state)."""
    flat = leaves(grads)
    if ef_state is not None:
        flat = [g + e for g, e in zip(flat, leaves(ef_state), strict=True)]
    q = [g.to(torch.bfloat16) for g in flat]
    if ef_state is None:
        return q, None
    return q, [g - x.to(g.dtype) for g, x in zip(flat, q)]


def decompress(q, dtype: torch.dtype = torch.float32) -> list:
    """The leaves of ``q`` cast to ``dtype``."""
    return [x.to(dtype) for x in leaves(q)]
