"""Weight bridge between the JAX parameter tree and the port.

Both packages keep one layout: nested dicts and lists (``blocks`` is a
list, each head's ``mlp`` a list of linears), a linear as ``{"w", "b"}``
with ``w`` of shape (d_in, d_out) applied as ``x @ w + b``, and each
GatedMLP packed as ``{"w", "b", "ln_scale", "ln_bias"}`` with
``w = [Wc ‖ Wg]``.  So the bridge copies arrays and transposes nothing,
and a round trip is bitwise.

``params_from_numpy`` takes the JAX tree after ``jax.tree.map(np.asarray,
params)``; this module never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.chgnet import CHGNet


def params_from_numpy(tree):
    """Numpy parameter tree -> the port's tree of CPU tensors (copies)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True))


def params_to_numpy(model: CHGNet):
    """A ``CHGNet``'s parameters -> the numpy tree (copies)."""
    return _to_numpy(model.tree())


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy().copy()
