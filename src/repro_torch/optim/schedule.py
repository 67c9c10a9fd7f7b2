"""Learning-rate schedules (paper §III-C, Eq. 14), PyTorch port of
``repro.optim.schedule``.

- ``scaled_init_lr``: init_LR = batchsize / k * 0.0003, k = 128.
- ``cosine_annealing``: the paper's scheduler with an optional linear
  warm-up, in f32 as the JAX package computes it.
"""
from __future__ import annotations

import math

import torch


def scaled_init_lr(batch_size: int, k: int = 128,
                   base_lr: float = 3e-4) -> float:
    """Eq. 14: LR grows linearly with the global batch size."""
    return batch_size / k * base_lr


def cosine_annealing(step, total_steps: int, init_lr: float, *,
                     warmup_steps: int = 0,
                     min_lr_ratio: float = 0.0) -> torch.Tensor:
    """The learning rate at ``step``, an f32 scalar tensor on the CPU."""
    step_f = torch.as_tensor(step, dtype=torch.float32)
    warm = init_lr * step_f / max(warmup_steps, 1)
    prog = (step_f - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = init_lr * (min_lr_ratio + (1 - min_lr_ratio) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step_f < warmup_steps, warm, cos)
