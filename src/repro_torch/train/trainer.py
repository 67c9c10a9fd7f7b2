"""Training step and a single-device Trainer, PyTorch port of
``repro.train.trainer`` (paper §III-C).

One step: ``chgnet_apply`` -> Huber loss -> backward (through the CUDA
forward kernels and their chunked-recompute backwards at
``conv_impl="fused"``) -> global-norm clip -> Adam at the cosine LR of
the step.  There is no ``jit``: PyTorch runs eagerly, and Adam updates
the parameters in place, which takes the place of the JAX package's
buffer donation.

Ported: ``TrainConfig`` field for field, ``chgnet_loss_fn``,
``_apply_grads`` (``apply_grads``) with the loss scaler, ``make_chgnet_
step_fns`` and a ``Trainer`` with ``train``, ``evaluate`` and ``serve``.

Mixed precision (DESIGN.md §4): when the policy computes below f32 the
step scales the loss (``TrainConfig.loss_scale``, state in
``opt_state["loss_scale"]``), unscales the gradients to f32 before the
clip, checks them for finite values, and on inf/nan skips the whole
update (parameters, moments and Adam's count) and backs the scale off;
bf16 parameters get f32 master weights in Adam.  The metrics gain
``loss_scale`` and ``grads_finite``.  Adam's count is a host value, so
the skip is decided on the host: the step's one device read, which also
brings the metrics, comes before Adam.

Every Trainer feature of a later ROADMAP item raises
``NotImplementedError`` naming it: divergence rollback and cost-model
refits (item 10), checkpoints, async writes and the shutdown hand-off
(item 12), and the mesh (item 13).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.chgnet import (
    CHGNetConfig,
    chgnet_apply,
    chgnet_init,
    check_supported,
    resolve_device,
)
from repro_torch.core.graph import CrystalGraphBatch
from repro_torch.core.losses import LossWeights, chgnet_loss
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.optim.grad import (
    clip_by_global_norm,
    global_norm,
    tree_all_finite,
    unscale_grads,
)
from repro_torch.optim.schedule import cosine_annealing, scaled_init_lr
from repro_torch.optim.tree import leaves
from repro_torch.precision import (
    LossScaleConfig,
    loss_scale_init,
    loss_scale_update,
    resolve_policy,
    scale_loss,
)

_TODO = "is not ported yet: ROADMAP 'Modules to port' item"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors ``repro.train.trainer.TrainConfig`` field for field; the
    fields of unported features must keep their defaults (``Trainer``
    raises otherwise)."""

    global_batch: int = 128
    total_steps: int = 1000
    warmup_steps: int = 0
    lr_k: int = 128                # Eq. 14 divisor
    base_lr: float = 3e-4
    grad_clip: float = 1.0
    grad_reduce: str = "bucketed"  # "plain" | "bucketed" | "compressed"
    adam: AdamConfig = AdamConfig()
    loss: LossWeights = LossWeights()
    loss_scale: LossScaleConfig = LossScaleConfig()
    cost_refit_every: int = 0
    cost_refit_warmup: int = 2
    cost_refit_window: int = 256
    rollback_on_divergence: bool = False
    divergence_nan_streak: int = 2
    divergence_spike_factor: float = 10.0
    divergence_spike_streak: int = 4
    divergence_window: int = 32
    rollback_lr_factor: float = 0.5
    max_rollbacks: int = 8

    @property
    def init_lr(self) -> float:
        return scaled_init_lr(self.global_batch, self.lr_k, self.base_lr)


def chgnet_loss_fn(params, cfg: CHGNetConfig, batch: CrystalGraphBatch,
                   weights: LossWeights):
    pred = chgnet_apply(params, cfg, batch)
    return chgnet_loss(pred, batch, weights)


def grads_of(loss, params) -> list:
    """d loss / d leaf for every leaf of ``params``, in ``optim.tree.leaves``
    order.  Leaves the loss never reaches (the last block's angle MLP, the
    final block's bond and angle MLPs) get zeros, as under ``jax.grad``."""
    flat = leaves(params)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(flat, grads)]


def _read(values: dict) -> dict:
    """One device read for every scalar in ``values``: 0-d f32 CPU
    tensors back."""
    host = torch.stack([v.detach().float().reshape(())
                        for v in values.values()]).tolist()
    return {k: torch.tensor(x) for k, x in zip(values, host)}


def apply_grads(grads, opt_state, params, lr, train_cfg: TrainConfig,
                scale_kind: str = "none", metrics: dict | None = None):
    """The shared tail of every train step, in place.  Returns ``(params,
    opt_state, extra_metrics)``; the extra metrics are the gradient's
    global norm before the clip and, with a loss scaler, the scale and
    ``grads_finite``.

    Without a scaler in ``opt_state``: clip -> Adam.  With one (DESIGN.md
    §4): unscale to f32 -> finite check -> clip -> Adam, and on inf/nan
    gradients no update at all (parameters, moments, count), then the
    scaler's update.  The finite flag has to reach the host before Adam
    (its count and bias corrections are host values): that read also
    takes the step's ``metrics``, returned as host values among the extra
    metrics, so the step still reads the device once."""
    scaler = opt_state.get("loss_scale")
    if scaler is None:
        norm = global_norm(grads)
        grads = clip_by_global_norm(grads, train_cfg.grad_clip)
        params, opt_state = adam_update(grads, opt_state, params, lr,
                                        train_cfg.adam)
        return params, opt_state, {"grad_norm": norm}
    adam_state = {k: v for k, v in opt_state.items() if k != "loss_scale"}
    # unscale to f32 before the clip, so that the clip threshold and the
    # finite check see the true gradients
    grads = unscale_grads(grads, scaler["scale"])
    host = _read(dict(metrics or {}, grad_norm=global_norm(grads),
                      grads_finite=tree_all_finite(grads)))
    finite = bool(host["grads_finite"])
    if finite:
        grads = clip_by_global_norm(grads, train_cfg.grad_clip)
        params, adam_state = adam_update(grads, adam_state, params, lr,
                                         train_cfg.adam)
    scaler = loss_scale_update(scaler, finite, train_cfg.loss_scale,
                               scale_kind)
    return params, dict(adam_state, loss_scale=scaler), dict(
        host, loss_scale=scaler["scale"])


def make_chgnet_step_fns(model_cfg: CHGNetConfig, train_cfg: TrainConfig):
    """Returns ``(train_step, eval_step, serve_step)``.

    ``train_step(params, opt_state, batch, step)`` updates ``params`` and
    ``opt_state`` in place and returns them with the step's metrics;
    ``eval_step(params, batch)`` gives the loss metrics and
    ``serve_step(params, batch)`` the predictions, both without autograd.
    The JAX signature's ``cache`` and ``donate`` are dropped: eager steps
    need no compile cache, and the in-place update already reuses the
    parameter and optimizer buffers.
    """

    def lr_at(step):
        return cosine_annealing(step, train_cfg.total_steps,
                                train_cfg.init_lr,
                                warmup_steps=train_cfg.warmup_steps)

    scale_kind = train_cfg.loss_scale.resolved_kind(model_cfg.precision)

    def train_step(params, opt_state, batch, step):
        loss, metrics = chgnet_loss_fn(params, model_cfg, batch,
                                       train_cfg.loss)
        scaler = opt_state.get("loss_scale")
        # the metrics carry the unscaled loss
        grads = grads_of(loss if scaler is None else scale_loss(loss, scaler),
                         params)
        params, opt_state, extra = apply_grads(
            grads, opt_state, params, lr_at(step), train_cfg, scale_kind,
            metrics)
        return params, opt_state, dict(metrics, **extra)

    @torch.no_grad()
    def eval_step(params, batch):
        return chgnet_loss_fn(params, model_cfg, batch, train_cfg.loss)[1]

    @torch.no_grad()
    def serve_step(params, batch):
        return chgnet_apply(params, model_cfg, batch)

    return train_step, eval_step, serve_step


def params_on(tree, device):
    """A copy of a parameter tree on ``device`` whose leaves record
    gradients (the training state ``Trainer`` keeps)."""
    if isinstance(tree, dict):
        return {k: params_on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_on(v, device) for v in tree]
    return tree.detach().to(device, copy=True).requires_grad_()


class Trainer:
    """Single-device training loop.

    The parameters are initialized from ``seed``; ``device=None`` means
    the card and raises without CUDA.  ``params``, ``opt_state`` and
    ``step`` are the training state; ``train(batches)`` takes CPU
    ``CrystalGraphBatch``es (``data.BatchIterator``), moves each to the
    device and returns the per-step metrics.
    """

    def __init__(self, model_cfg: CHGNetConfig, train_cfg: TrainConfig, *,
                 seed: int = 0, device=None, mesh=None,
                 ckpt_dir: str | None = None, async_ckpt: bool = False,
                 shutdown=None):
        check_supported(model_cfg)
        if mesh is not None:
            raise NotImplementedError(f"mesh= (data parallelism) {_TODO} 13")
        if ckpt_dir is not None or async_ckpt or shutdown is not None:
            raise NotImplementedError(
                f"checkpoints, async writes and shutdown {_TODO} 12")
        if train_cfg.rollback_on_divergence:
            raise NotImplementedError(f"rollback_on_divergence {_TODO} 10")
        if train_cfg.cost_refit_every:
            raise NotImplementedError(f"cost_refit_every {_TODO} 10")
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.device = resolve_device(device)
        self.params = params_on(chgnet_init(seed, model_cfg), self.device)
        # mixed precision (DESIGN.md §4): bf16 parameter storage gets f32
        # master weights in Adam; a compute dtype below f32 a loss scaler,
        # whose state rides in opt_state
        policy = resolve_policy(model_cfg.precision)
        self.opt_state = adam_init(
            self.params, master_dtype=torch.float32
            if policy.needs_master_weights else None)
        if train_cfg.loss_scale.resolved_kind(policy) != "none":
            self.opt_state["loss_scale"] = loss_scale_init(
                train_cfg.loss_scale)
        self.step = 0
        self._train_step, self._eval_step, self._serve_step = \
            make_chgnet_step_fns(model_cfg, train_cfg)

    def evaluate(self, batch: CrystalGraphBatch) -> dict:
        """Loss metrics on one batch."""
        metrics = self._eval_step(self.params, batch.to(self.device))
        return dict(zip(metrics, torch.stack(list(metrics.values()))
                        .tolist()))

    def serve(self, batch: CrystalGraphBatch) -> dict:
        """One inference step (energy, forces, stress, magmom)."""
        return self._serve_step(self.params, batch.to(self.device))

    def train(self, batches, max_steps: int | None = None,
              fault_injector=None) -> list[dict]:
        if fault_injector is not None:
            raise NotImplementedError(f"fault_injector= {_TODO} 12")
        history = []
        for batch in batches:
            if max_steps is not None and self.step >= max_steps:
                break
            if not isinstance(batch, CrystalGraphBatch):
                raise NotImplementedError(
                    f"{type(batch).__name__} batches (accumulation plans, "
                    f"tagged batches) {_TODO} 10")
            self.params, self.opt_state, metrics = self._train_step(
                self.params, self.opt_state, batch.to(self.device),
                self.step)
            # one device read per step for all the metrics (with a loss
            # scaler the step has made it, and these are host values)
            values = dict(zip(metrics, torch.stack(
                [v.detach().float() for v in metrics.values()]).tolist()))
            # a step the scaler skipped (grads_finite 0) left the state
            # untouched: not a fault
            skipped = not values.get("grads_finite", 1.0)
            if not torch.isfinite(torch.tensor(values["loss"])) \
                    and not skipped:
                raise FloatingPointError(
                    f"non-finite loss at step {self.step}")
            self.step += 1
            history.append(values)
        return history
