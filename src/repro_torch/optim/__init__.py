"""Optimizer of the port: Adam over the parameter tree, the global-norm
clip and the Eq. 14 learning-rate schedule."""
from .adam import AdamConfig, adam_init, adam_update
from .grad import (
    clip_by_global_norm,
    global_norm,
    tree_all_finite,
    unscale_grads,
)
from .schedule import cosine_annealing, scaled_init_lr

__all__ = [
    "AdamConfig", "adam_init", "adam_update",
    "clip_by_global_norm", "global_norm", "tree_all_finite", "unscale_grads",
    "cosine_annealing", "scaled_init_lr",
]
