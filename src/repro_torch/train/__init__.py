"""Training step and Trainer of the port."""
from .trainer import (
    TrainConfig,
    Trainer,
    chgnet_loss_fn,
    make_chgnet_step_fns,
)

__all__ = ["TrainConfig", "Trainer", "chgnet_loss_fn", "make_chgnet_step_fns"]
