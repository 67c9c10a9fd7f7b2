"""Weight bridge between the JAX parameter tree and the port.

Both packages keep one layout: nested dicts and lists (``blocks`` is a
list, each head's ``mlp`` a list of linears), a linear as ``{"w", "b"}``
with ``w`` of shape (d_in, d_out) applied as ``x @ w + b``, and each
GatedMLP packed as ``{"w", "b", "ln_scale", "ln_bias"}`` with
``w = [Wc ‖ Wg]``.  So the bridge copies arrays and transposes nothing,
and a round trip is bitwise.

``params_from_numpy`` takes the JAX tree after ``jax.tree.map(np.asarray,
params)``; this module never imports JAX.  ``lm_params_from_numpy`` does
the same for the LM substrate's tree (``models.transformer``).  Leaves
may be bf16 (the ``"bf16"`` precision policy, the LM's weights): numpy's
``bfloat16`` (the ``ml_dtypes`` extension type, which ``torch.from_numpy``
does not take) becomes ``torch.bfloat16`` and back bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.chgnet import CHGNet


def _leaf_from_numpy(x) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr.view(np.uint16), copy=True)
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_numpy(tree):
    """Numpy parameter tree -> the port's tree of CPU tensors (copies)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v) for v in tree]
    return _leaf_from_numpy(tree)


def params_to_numpy(model: CHGNet):
    """A ``CHGNet``'s parameters -> the numpy tree (copies)."""
    return _to_numpy(model.tree())


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, needed for bf16 leaves only

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def lm_params_from_numpy(tree):
    """Numpy LM parameter tree (``repro.models.transformer.decoder_init``'s
    layout after ``jax.tree.map(np.asarray, ...)``) -> the port's tree of
    CPU tensors: the same nested dicts, stacked ``layers`` leaves and
    ``x @ w`` weights, so every leaf is copied and none transposed.  bf16
    leaves (numpy's ``bfloat16`` extension type, which ``torch.from_numpy``
    does not take) are copied bit for bit as ``torch.bfloat16``."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v) for k, v in tree.items()}
    return _leaf_from_numpy(tree)
