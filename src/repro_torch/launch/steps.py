"""LM training step of the port: the train step of
``repro.launch.steps.build_cell`` without the mesh.

``lm_grads`` splits the batch into ``accum_steps`` microbatches
(microbatch-major, as ``build_cell``'s ``to_micro``), sums their
gradients and divides by K.  ``make_lm_train_step`` then optionally
rounds those gradients through bf16 (the compressed all-reduce's
rounding), clips them by their global norm (``optim.grad.
clip_by_global_norm``'s scale, applied in place) and takes one Adam step
in place.  The step is eager: the JAX version's donation of parameters
and moments is the in-place update here.
"""
from __future__ import annotations

import torch

from repro_torch.models.api import family_fns
from repro_torch.models.config import LMConfig
from repro_torch.optim.adam import adam_update
from repro_torch.optim.grad import global_norm
from repro_torch.optim.tree import leaves


def lm_grads(cfg: LMConfig, params, inputs, accum_steps: int = 1,
             **loss_kw):
    """``(loss, grads)``: the mean loss over ``accum_steps`` microbatches
    of ``inputs`` (the family's: tokens or whisper's frames, labels, and
    positions where the family has them), a 0-d f32 tensor, and the
    gradients of ``params``' leaves (in ``leaves`` order; the leaves are
    set to require gradients) summed over the microbatches and divided
    by K.  ``loss_kw`` goes to the family's loss (``ssd_chunk``)."""
    loss_fn = family_fns(cfg).loss
    b = inputs[0].shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} does not split into {accum_steps} "
                         "microbatches")
    micro = [x.reshape(accum_steps, b // accum_steps, *x.shape[1:])
             for x in inputs]
    flat = [p.requires_grad_() for p in leaves(params)]
    gsum, loss_sum = None, torch.zeros((), device=flat[0].device)
    for i in range(accum_steps):
        loss = loss_fn(cfg, params, *(m[i] for m in micro), **loss_kw)
        grads = list(torch.autograd.grad(loss, flat))
        if gsum is None:
            gsum = grads
        else:
            torch._foreach_add_(gsum, grads)
        loss_sum = loss_sum + loss.detach()
        del grads
    # in place from here: at LM scale each copy of the gradients is
    # 4 bytes a parameter (6 GB for 1.5 B)
    with torch.no_grad():
        torch._foreach_div_(gsum, float(accum_steps))
    return loss_sum / accum_steps, gsum


def make_lm_train_step(cfg: LMConfig, *, accum_steps: int = 1,
                       lr: float = 1e-4, grad_clip: float = 1.0,
                       compress_grads: bool = False, **loss_kw):
    """``train_step(params, opt_state, *inputs) -> (params, opt_state,
    loss)``, ``inputs`` the family's (``lm_grads``): ``params`` (f32
    master weights) and ``opt_state`` (``adam_init``) are updated in
    place, ``loss`` is the microbatches' mean loss, a 0-d f32 tensor on
    the parameters' device.  ``grad_clip=math.inf`` leaves the gradients
    unclipped; ``loss_kw`` goes to the family's loss (the hybrid's
    ``ssd_chunk``)."""

    def train_step(params, opt_state, *inputs):
        loss, grads = lm_grads(cfg, params, inputs, accum_steps, **loss_kw)
        with torch.no_grad():
            if compress_grads:
                for g in grads:
                    g.copy_(g.to(torch.bfloat16))
            torch._foreach_mul_(grads, torch.clamp(
                grad_clip / (global_norm(grads) + 1e-12), max=1.0))
        params, opt_state = adam_update(grads, opt_state, params, lr)
        return params, opt_state, loss

    return train_step
