"""Training steps and the Trainer, PyTorch port of
``repro.train.trainer`` (paper §III-C).

One step: ``chgnet_apply`` -> Huber loss -> backward (through the CUDA
forward kernels and their chunked-recompute backwards at
``conv_impl="fused"``) -> global-norm clip -> Adam at the cosine LR of
the step.  There is no ``jit``: PyTorch runs eagerly, and Adam updates
the parameters in place, which takes the place of the JAX package's
buffer donation.

Ported: ``TrainConfig`` field for field, ``chgnet_loss_fn``,
``_apply_grads`` (``apply_grads``) with the loss scaler, ``make_chgnet_
step_fns``, the data-parallel steps and a ``Trainer`` with ``train``,
``evaluate`` and ``serve``.

Mixed precision (DESIGN.md §4): when the policy computes below f32 the
step scales the loss (``TrainConfig.loss_scale``, state in
``opt_state["loss_scale"]``), unscales the gradients to f32 before the
clip, checks them for finite values, and on inf/nan skips the whole
update (parameters, moments and Adam's count) and backs the scale off;
bf16 parameters get f32 master weights in Adam.  The metrics gain
``loss_scale`` and ``grads_finite``.  Adam's count is a host value, so
the skip is decided on the host: the step's one device read, which also
brings the metrics, comes before Adam.

Accumulation over uneven capacity buckets (DESIGN.md §6):
``make_chgnet_accum_step_fns`` gives each microbatch's gradients of its
global-denominator partial loss and one apply step; ``Trainer`` takes a
``StepPlan`` (``data.BalancedBatchIterator``) as one optimizer step, sums
its microbatches' gradients in order, and can refit the bin packer's cost
model from measured microbatch times (``cost_refit_every``).

Data parallelism (DESIGN.md §6) over a ``distributed.DataMesh``: each
rank holds a full replica of the parameters and optimizer state, takes
the loss and gradients of its own shard, all-reduces the *scaled*
gradients by ``TrainConfig.grad_reduce`` (``plain`` / ``bucketed`` /
``compressed``), divides by the mesh size and runs the replicated tail
(``make_dp_train_step``, ``make_dp_eval_step``, ``make_dp_serve_step``,
and the mesh half of ``make_chgnet_accum_step_fns``).  Whatever the JAX
package decides once in one process, the ranks agree on: the inf/nan
skip (identical reduced gradients), the divergence sentinel's loss (the
mean), the quarantine (global indices), the cost refit (a microbatch's
time is the slowest rank's) and a SIGTERM (a stop flag reduced with the
step's metrics, so every rank stops at the same step and rank 0 writes
the final checkpoint).

Runtime (DESIGN.md §8): periodic verified checkpoints (sync, or async on
a writer thread; on a mesh rank 0 writes and a barrier follows, and every
rank restores the same file), ``maybe_restore`` with the legacy-f32 and
packed-GatedMLP migrations, divergence rollback with quarantine
(``rollback_on_divergence``), and the SIGTERM hand-off (``shutdown``: a
final checkpoint, a resume marker, ``PreemptionError``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.batching.balance import StepPlan
from repro_torch.batching.cost import fit_cost_model
from repro_torch.core.chgnet import (
    CHGNetConfig,
    chgnet_apply,
    chgnet_init,
    resolve_device,
)
from repro_torch.core.graph import CrystalGraphBatch
from repro_torch.core.interaction import (
    gated_mlp_legacy_template,
    pack_gated_mlp_params,
)
from repro_torch.core.losses import (
    LossWeights,
    chgnet_loss,
    chgnet_loss_sums,
    metrics_from_sums,
)
from repro_torch.data.pipeline import TaggedBatch
from repro_torch.distributed import (
    DataMesh,
    all_reduce_grads,
    mean_metrics,
    stack_over_ranks,
    sum_scalars,
)
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
    cast_float_tree,
    loss_scale_init,
    loss_scale_update,
    resolve_policy,
    scale_loss,
)
from repro_torch.runtime.async_ckpt import AsyncCheckpointWriter
from repro_torch.runtime.checkpoint import (
    MissingLeafError,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.runtime.fault import (
    DivergenceSentinel,
    PreemptionError,
    StragglerWatch,
    write_resume_marker,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors ``repro.train.trainer.TrainConfig`` field for field.

    ``cost_refit_every`` (DESIGN.md §6): every K optimizer steps the
    Trainer refits ``batching.cost.fit_cost_model`` from the measured
    microbatch times of ``StepPlan`` steps (a device synchronise per
    microbatch, paid only when on) and hands it to ``on_cost_model``;
    the first ``cost_refit_warmup`` plans are not sampled, and at most
    ``cost_refit_window`` samples are kept.  ``rollback_on_divergence``
    (DESIGN.md §8): a streak of non-finite losses or of loss spikes
    (``divergence_*``) restores the newest valid checkpoint, multiplies
    the LR by ``rollback_lr_factor`` (``opt_state["lr_scale"]``, so it is
    checkpointed) and quarantines the streak's indices through
    ``on_quarantine``; scaler-skipped steps never count."""

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


def _host_values(metrics: dict) -> dict:
    """Every metric as a float, the device ones in one read (with a loss
    scaler the step has made it already, and they are host values)."""
    on_device = [k for k, v in metrics.items() if v.device.type != "cpu"]
    read = dict(zip(on_device, torch.stack(
        [metrics[k].detach().float() for k in on_device]).tolist())) \
        if on_device else {}
    return {k: read[k] if k in read else float(metrics[k].detach())
            for k in metrics}


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
    metrics, so the step still reads the device once.

    An ``opt_state["lr_scale"]`` (divergence rollback, DESIGN.md §8)
    multiplies the schedule's LR, passes through Adam like any extra
    state key, and is reported among the extra metrics."""
    lr_scale = opt_state.get("lr_scale")
    if lr_scale is not None:
        lr = lr * lr_scale
    extra = {} if lr_scale is None else {"lr_scale": lr_scale}
    scaler = opt_state.get("loss_scale")
    if scaler is None:
        norm = global_norm(grads)
        grads = clip_by_global_norm(grads, train_cfg.grad_clip)
        params, opt_state = adam_update(grads, opt_state, params, lr,
                                        train_cfg.adam)
        return params, opt_state, dict(extra, grad_norm=norm)
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
        host, loss_scale=scaler["scale"], **extra)


def _lr_schedule(train_cfg: TrainConfig):
    """The step -> LR function of ``train_cfg`` (cosine annealing from
    the Eq. 14 initial LR)."""

    def lr_at(step):
        return cosine_annealing(step, train_cfg.total_steps,
                                train_cfg.init_lr,
                                warmup_steps=train_cfg.warmup_steps)

    return lr_at


def make_chgnet_step_fns(model_cfg: CHGNetConfig, train_cfg: TrainConfig):
    """Returns ``(train_step, eval_step, serve_step)``.

    ``train_step(params, opt_state, batch, step, stop=None)`` updates
    ``params`` and ``opt_state`` in place and returns them with the step's
    metrics (``stop`` is the DP step's; it is not read here);
    ``eval_step(params, batch)`` gives the loss metrics and
    ``serve_step(params, batch)`` the predictions, both without autograd.
    The JAX signature's ``cache`` and ``donate`` are dropped: eager steps
    need no compile cache, and the in-place update already reuses the
    parameter and optimizer buffers.
    """

    lr_at = _lr_schedule(train_cfg)
    scale_kind = train_cfg.loss_scale.resolved_kind(model_cfg.precision)

    def train_step(params, opt_state, batch, step, stop=None):
        del stop  # the DP step's SIGTERM flag: one device agrees alone
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


def make_chgnet_eval_serve_step(model_cfg: CHGNetConfig,
                                train_cfg: TrainConfig):
    """``eval_serve_step(params, batch) -> (metrics, outputs)``: ONE
    forward, whose outputs are returned and give the eval metrics, for
    callers that want predictions and errors (validation that archives
    outputs, MD loops that log errors) without two forwards.  It runs
    under ``torch.no_grad()`` like ``serve_step``: the direct readout
    records nothing, the autodiff readout turns autograd on for its own
    derivative.  The JAX signature's ``cache`` and ``donate`` are dropped
    (``make_chgnet_step_fns``)."""

    @torch.no_grad()
    def eval_serve_step(params, batch):
        out = chgnet_apply(params, model_cfg, batch)
        return chgnet_loss(out, batch, train_cfg.loss)[1], out

    return eval_serve_step


def _with_stop(values: dict, stop) -> dict:
    """``values`` plus this rank's stop flag (SIGTERM) as a float, to ride
    the step's metrics all-reduce; unchanged when ``stop`` is None."""
    return values if stop is None else dict(values, stop=float(stop))


def make_dp_train_step(model_cfg: CHGNetConfig, train_cfg: TrainConfig,
                       mesh: DataMesh):
    """Train step over this rank's shard of each global batch, the port of
    the JAX package's ``shard_map`` step: the loss and gradients of the
    local shard, an all-reduce of the *scaled* gradients by
    ``train_cfg.grad_reduce``, division by the mesh size, the replicated
    ``apply_grads`` (unscale, finite check, clip, Adam, skip), and the
    metrics averaged over the ranks.

    ``train_step(params, opt_state, batch, step, stop=None)``: ``batch`` is
    this rank's ``CrystalGraphBatch``.  ``stop`` (this rank's SIGTERM
    flag) rides the metrics' all-reduce and comes back as the metric
    ``stop``, above 0 when any rank was asked to stop.
    """
    lr_at = _lr_schedule(train_cfg)
    scale_kind = train_cfg.loss_scale.resolved_kind(model_cfg.precision)

    def train_step(params, opt_state, batch, step, stop=None):
        loss, metrics = chgnet_loss_fn(params, model_cfg, batch,
                                       train_cfg.loss)
        scaler = opt_state.get("loss_scale")
        grads = grads_of(loss if scaler is None else scale_loss(loss, scaler),
                         params)
        # the all-reduce sees the scaled gradients (scaling lifts small
        # cotangents above bf16's rounding before the compressed
        # collective); unscale and the skip run replicated after it, so
        # every rank takes the same decision
        grads = torch._foreach_div(
            all_reduce_grads(grads, mesh, train_cfg.grad_reduce),
            float(mesh.size))
        metrics = mean_metrics(_with_stop(metrics, stop), mesh)
        params, opt_state, extra = apply_grads(
            grads, opt_state, params, lr_at(step), train_cfg, scale_kind,
            metrics)
        return params, opt_state, dict(metrics, **extra)

    return train_step


def make_dp_eval_step(model_cfg: CHGNetConfig, train_cfg: TrainConfig,
                      mesh: DataMesh):
    """``eval_step(params, batch)``: the loss metrics of this rank's shard,
    averaged over the ranks."""

    @torch.no_grad()
    def eval_step(params, batch):
        return mean_metrics(
            chgnet_loss_fn(params, model_cfg, batch, train_cfg.loss)[1],
            mesh)

    return eval_step


def make_dp_serve_step(model_cfg: CHGNetConfig, mesh: DataMesh):
    """``serve_step(params, batch)``: the predictions of this rank's shard,
    stacked over the ranks on a leading device axis (every rank gets all
    of them, as ``shard_map``'s ``out_specs=P("data")``)."""

    @torch.no_grad()
    def serve_step(params, batch):
        return stack_over_ranks(chgnet_apply(params, model_cfg, batch), mesh)

    return serve_step


def make_chgnet_accum_step_fns(model_cfg: CHGNetConfig,
                               train_cfg: TrainConfig, *,
                               mesh: DataMesh | None = None):
    """Returns ``(grad_step, apply_step)`` for accumulation over uneven
    capacity buckets (DESIGN.md §6), the port of the JAX package's
    function of that name.

      - ``grad_step(params, batch, denoms, scaler, stop=None) -> (grads,
        sums)``: the gradients (a list in ``optim.tree.leaves`` order) of
        this microbatch's *partial* loss, masked Huber sums over the
        step's global ``denoms`` (``losses.global_denominators``), times
        the loss scale when ``scaler`` (``opt_state["loss_scale"]``) is
        given, and the detached sums.  Because the denominators are
        global, the microbatches' losses and gradients add up to the
        single big batch's (up to f32 reassociation).  On a ``mesh`` the
        gradients (by ``grad_reduce``) and the sums are all-reduced with no
        division, the device half of that same sum: the global
        denominators already normalize, and a rank left idle by a small
        microbatch adds the exact zeros of its all-padding shard; ``stop``
        rides the sums' all-reduce as the sum ``stop``.
      - ``apply_step(params, opt_state, grads, sums, denoms, step)``: the
        shared tail (``apply_grads``: unscale, finite check, clip, Adam,
        skip on inf/nan, scaler update) on the summed gradients, and the
        step's metrics from the summed sums.  An inf/nan in any
        microbatch poisons the sum, so the one finite check skips the
        whole step, as for a single batch.
    """

    lr_at = _lr_schedule(train_cfg)
    scale_kind = train_cfg.loss_scale.resolved_kind(model_cfg.precision)

    def grad_step(params, batch, denoms, scaler=None, stop=None):
        pred = chgnet_apply(params, model_cfg, batch)
        loss, sums = chgnet_loss_sums(pred, batch, train_cfg.loss, denoms)
        grads = grads_of(loss if scaler is None else scale_loss(loss, scaler),
                         params)
        sums = {k: v.detach() for k, v in sums.items()}
        if mesh is None:
            return grads, sums
        return (all_reduce_grads(grads, mesh, train_cfg.grad_reduce),
                sum_scalars(_with_stop(sums, stop), mesh))

    def apply_step(params, opt_state, grads, sums, denoms, step):
        metrics = metrics_from_sums(sums, denoms)
        if "stop" in sums:
            metrics["stop"] = sums["stop"]
        params, opt_state, extra = apply_grads(
            grads, opt_state, params, lr_at(step), train_cfg, scale_kind,
            metrics)
        return params, opt_state, dict(metrics, **extra)

    return grad_step, apply_step


def _strip_precision_state(state: dict) -> dict:
    """Trainer-state template minus the policy-dependent leaves
    (``opt_state["loss_scale"]`` / ``["master"]`` of DESIGN.md §4,
    ``["lr_scale"]`` of the §8 rollback): the shape a checkpoint written
    under other flags has.  The restore re-grows what this trainer
    wants."""
    opt = {k: v for k, v in state["opt_state"].items()
           if k not in ("loss_scale", "master", "lr_scale")}
    return dict(state, opt_state=opt)


def params_on(tree, device):
    """A copy of a parameter tree on ``device`` whose leaves record
    gradients (the training state ``Trainer`` keeps)."""
    if isinstance(tree, dict):
        return {k: params_on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_on(v, device) for v in tree]
    return tree.detach().to(device, copy=True).requires_grad_()


class Trainer:
    """Training loop with periodic verified checkpoints, on one device or
    one rank of a data-parallel mesh.

    The parameters are initialized from ``seed``; ``device=None`` means
    the card and raises without CUDA.  ``params``, ``opt_state`` and
    ``step`` are the training state.  ``train(batches)`` takes CPU or
    device ``CrystalGraphBatch``es (``data.BatchIterator``), ``StepPlan``s
    (``data.BalancedBatchIterator``: one optimizer step over several
    microbatches) or either wrapped in a ``TaggedBatch``, moves each to
    the device and returns the per-step metrics.

    ``mesh`` (a ``distributed.DataMesh``) trains this rank's replica on
    the mesh's device: every rank builds the same parameters from the
    same seed, takes its own shard of each step (the iterators'
    ``shard=mesh.rank``) and the DP steps keep the replicas equal;
    ``evaluate`` averages the ranks' metrics and ``serve`` stacks their
    outputs on a leading device axis.  ``rebuild_mesh`` re-targets the
    trainer at a shrunken mesh (``runtime.elastic_train``).

    ``ckpt_dir`` turns on a checkpoint every ``ckpt_every`` steps (only of
    states the divergence sentinel finds healthy), keeping ``keep`` valid
    files; ``async_ckpt`` writes them on a writer thread; ``shutdown`` (a
    ``runtime.GracefulShutdown``) is polled before every step.  The hooks
    ``on_cost_model`` and ``on_quarantine`` receive refit cost models and
    quarantined dataset indices (the launcher wires them to the
    iterator's ``update_cost_model`` and ``add_quarantine``).
    """

    def __init__(self, model_cfg: CHGNetConfig, train_cfg: TrainConfig, *,
                 seed: int = 0, device=None, mesh: DataMesh | None = None,
                 ckpt_dir: str | None = None, ckpt_every: int = 100,
                 keep: int = 3, async_ckpt: bool = False, shutdown=None):
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"device {mesh.device}")
            device = mesh.device
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
        self._scale_kind = train_cfg.loss_scale.resolved_kind(policy)
        if self._scale_kind != "none":
            self.opt_state["loss_scale"] = loss_scale_init(
                train_cfg.loss_scale)
        self.step = 0
        self.mesh = mesh
        self._build_steps()
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        # async checkpoints (DESIGN.md §8): snapshot on the loop thread,
        # serialize, fsync and prune on a writer thread, started by the
        # first save of the rank that writes
        self.async_ckpt = async_ckpt
        self._ckpt_writer = None
        self.shutdown = shutdown
        # on a mesh, a SIGTERM counts once the ranks agree on it (the stop
        # flag reduced with the step's metrics)
        self._agreed_stop = False
        self.straggler = StragglerWatch()
        # divergence rollback (DESIGN.md §8): lr_scale rides in opt_state
        # so that a backed-off LR survives checkpoints
        if train_cfg.rollback_on_divergence:
            self.sentinel = DivergenceSentinel(
                window=train_cfg.divergence_window,
                nan_streak=train_cfg.divergence_nan_streak,
                spike_factor=train_cfg.divergence_spike_factor,
                spike_streak=train_cfg.divergence_spike_streak)
            self.opt_state["lr_scale"] = torch.tensor(1.0)
        else:
            self.sentinel = None
        self._lr_scale = 1.0
        self.rollbacks = 0
        self.quarantined: set[int] = set()
        self.on_quarantine: Callable[[list[int]], None] | None = None
        self._recent_indices: deque = deque(maxlen=max(2 * ckpt_every, 64))
        # live cost-model refits (TrainConfig.cost_refit_every):
        # (micro_sizes, seconds) samples, the latest fit, its consumer
        self._cost_samples: list[tuple[Any, float]] = []
        self._profiled_plans = 0
        self.cost_model = None
        self.on_cost_model: Callable[[Any], None] | None = None

    def _build_steps(self):
        """The step functions of the current ``mesh`` (DP steps on one)."""
        if self.mesh is None:
            self._train_step, self._eval_step, self._serve_step = \
                make_chgnet_step_fns(self.model_cfg, self.train_cfg)
        else:
            self._train_step = make_dp_train_step(
                self.model_cfg, self.train_cfg, self.mesh)
            self._eval_step = make_dp_eval_step(
                self.model_cfg, self.train_cfg, self.mesh)
            self._serve_step = make_dp_serve_step(self.model_cfg, self.mesh)
        self._grad_step, self._apply_step = make_chgnet_accum_step_fns(
            self.model_cfg, self.train_cfg, mesh=self.mesh)

    @property
    def num_devices(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def rebuild_mesh(self, mesh: DataMesh | None):
        """Re-target the trainer at a (shrunken) mesh, as the elastic path
        does after a device drop: the replica stays on this rank's device,
        with its optimizer state, and the step functions are rebuilt."""
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"mesh device {mesh.device} is not the "
                             f"trainer's {self.device}")
        self.mesh = mesh
        self._build_steps()

    # -- checkpoints ----------------------------------------------------------
    @property
    def _writes_checkpoints(self) -> bool:
        """One device, or position 0 of the mesh: the rank that writes."""
        return self.mesh is None or self.mesh.rank == 0

    def state(self) -> dict:
        return {"params": self.params, "opt_state": self.opt_state}

    def save(self, *, wait: bool = False):
        """Checkpoint the current state (async when built with
        ``async_ckpt=True``; ``wait`` makes it durable before returning,
        as final and preemption saves need).  On a mesh rank 0 writes (the
        replicas are equal) and a barrier follows."""
        if self.ckpt_dir is None:
            return
        if self._writes_checkpoints:
            self._write(wait)
        if self.mesh is not None:
            self.mesh.barrier()

    def _write(self, wait: bool):
        meta = {"model_cfg": dataclasses.asdict(self.model_cfg)}
        if self.async_ckpt:
            if self._ckpt_writer is None:
                self._ckpt_writer = AsyncCheckpointWriter(self.ckpt_dir,
                                                          keep=self.keep)
            self._ckpt_writer.save(self.step, self.state(), extra_meta=meta)
            if wait:
                self._ckpt_writer.flush()
            return
        save_checkpoint(self.ckpt_dir, self.step, self.state(),
                        keep=self.keep, extra_meta=meta)

    def flush_checkpoints(self):
        """Block until every queued async checkpoint is durably written."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.flush()

    def close(self):
        """Flush and stop the async checkpoint writer (idempotent)."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.close()

    def maybe_restore(self) -> bool:
        """Restore the newest valid checkpoint of ``ckpt_dir`` (False if
        there is none).  Two layout migrations, each applied at most once:
        a legacy f32 checkpoint (no ``loss_scale`` / ``master`` /
        ``lr_scale`` leaves) restores into a stripped template and the
        missing state is re-grown; a legacy separate-weight GatedMLP
        restores into the legacy template and is packed once.  Any other
        missing leaf, or a failed migration, raises the first error.  On a
        mesh every rank restores the same file, once rank 0's in-flight
        write has landed."""
        if self.ckpt_dir is None:
            return False
        # land any in-flight async write first, so that it counts
        self.flush_checkpoints()
        if self.mesh is not None:
            self.mesh.barrier()
        if latest_step(self.ckpt_dir) is None:
            return False
        packed_keys = ("['w']", "['b']", "['ln_scale']", "['ln_bias']")
        precision_keys = ("['loss_scale']", "['master']", "['lr_scale']")
        wants_master = "master" in self.opt_state
        template = self.state()
        stripped = packed = False
        first_err = None
        while True:
            try:
                state, step, _ = restore_checkpoint(self.ckpt_dir, template)
                break
            except MissingLeafError as missing:
                first_err = first_err or missing
                if not stripped and any(k in missing.leaf_path
                                        for k in precision_keys):
                    template = _strip_precision_state(template)
                    stripped = True
                    continue
                if not packed and missing.leaf_path.endswith(packed_keys):
                    template = gated_mlp_legacy_template(template)
                    packed = True
                    continue
                raise missing
            except (KeyError, ValueError):
                if first_err is not None:
                    raise first_err
                raise
        if packed:
            state = pack_gated_mlp_params(state)
            # the packed parameters are new leaves that record gradients
            state["params"] = params_on(state["params"], self.device)
        self.params, self.opt_state = state["params"], state["opt_state"]
        if stripped:
            # legacy f32 -> this trainer's policy: master weights re-grown
            # from the restored params, the scaler at its initial scale
            if wants_master:
                self.opt_state["master"] = cast_float_tree(
                    self.params, torch.float32)
            if self._scale_kind != "none":
                self.opt_state["loss_scale"] = loss_scale_init(
                    self.train_cfg.loss_scale)
            if self.train_cfg.rollback_on_divergence:
                # at the CURRENT cumulative rollback factor, so that a
                # restore after a rollback keeps the backed-off LR
                self.opt_state["lr_scale"] = torch.tensor(self._lr_scale)
        self.step = step
        return True

    # -- eval / serve ---------------------------------------------------------
    def evaluate(self, batch: CrystalGraphBatch) -> dict:
        """Loss metrics on one batch."""
        metrics = self._eval_step(self.params, batch.to(self.device))
        return dict(zip(metrics, torch.stack(list(metrics.values()))
                        .tolist()))

    def serve(self, batch: CrystalGraphBatch) -> dict:
        """One inference step (energy, forces, stress, magmom)."""
        return self._serve_step(self.params, batch.to(self.device))

    # -- gradient accumulation (DESIGN.md §6) ---------------------------------
    def _step_plan(self, plan: StepPlan, stop=None):
        """One optimizer step over a balanced multi-bucket StepPlan: the
        microbatches' gradients (global-denominator partial losses) are
        summed in microbatch order, then applied once: the update a
        single big-batch step would take.  On a mesh each microbatch is
        this rank's shard, its gradients and sums all-reduced."""
        scaler = self.opt_state.get("loss_scale")
        # per-microbatch times for the live cost-model refit: only when
        # enabled (the synchronise stops the host running ahead), only past
        # the warm-up, and only for plans that carry their real sizes
        profile = (self.train_cfg.cost_refit_every > 0
                   and plan.micro_sizes is not None)
        sync = profile and self.device.type == "cuda"
        gsum = ssum = None
        times = []
        for micro in plan.micro:
            t0 = time.perf_counter() if profile else 0.0
            grads, sums = self._grad_step(
                self.params, micro.to(self.device), plan.denoms, scaler,
                stop)
            if sync:
                torch.cuda.synchronize(self.device)
            if profile:
                times.append(time.perf_counter() - t0)
            if gsum is None:
                gsum, ssum = grads, sums
            else:
                torch._foreach_add_(gsum, grads)
                ssum = {k: ssum[k] + sums[k] for k in ssum}
        if profile:
            if self.mesh is not None:
                # a microbatch takes as long as its slowest rank, and every
                # rank must fit the same model to pack the same plans
                times = self.mesh.all_reduce(torch.tensor(
                    times, dtype=torch.float64, device=self.device),
                    "max").tolist()
            if self._profiled_plans >= self.train_cfg.cost_refit_warmup:
                self._cost_samples.extend(zip(plan.micro_sizes, times))
            self._profiled_plans += 1
            del self._cost_samples[:-self.train_cfg.cost_refit_window]
        return self._apply_step(self.params, self.opt_state, gsum, ssum,
                                plan.denoms, self.step)

    def _maybe_refit_cost_model(self):
        """Refit the LPT cost model from the recorded (sizes, seconds)
        samples every ``cost_refit_every`` steps and push it to
        ``on_cost_model`` (DESIGN.md §6); needs at least 4 samples (the
        affine fit has 4 coefficients)."""
        every = self.train_cfg.cost_refit_every
        if every <= 0 or self.step % every or len(self._cost_samples) < 4:
            return
        sizes = np.asarray([s for s, _ in self._cost_samples], np.float64)
        times = np.asarray([t for _, t in self._cost_samples], np.float64)
        self.cost_model = fit_cost_model(sizes, times)
        if self.on_cost_model is not None:
            self.on_cost_model(self.cost_model)

    # -- divergence rollback / preemption (DESIGN.md §8) ----------------------
    def _rollback(self):
        """The sentinel tripped: quarantine the streak's batches, restore
        the newest valid checkpoint and back the LR off."""
        self.rollbacks += 1
        if self.rollbacks > self.train_cfg.max_rollbacks:
            raise FloatingPointError(
                f"divergence persists after {self.train_cfg.max_rollbacks} "
                f"rollbacks (step {self.step})")
        # the streak's batches are the prime suspects
        trip_len = self.sentinel.last_trip_len if self.sentinel else 0
        fresh: set[int] = set()
        for _, idx in list(self._recent_indices)[-max(trip_len, 1):]:
            fresh.update(int(i) for i in idx)
        fresh -= self.quarantined
        if fresh:
            self.quarantined |= fresh
            if self.on_quarantine is not None:
                self.on_quarantine(sorted(fresh))
        if not self.maybe_restore():
            raise FloatingPointError(
                f"divergence at step {self.step} with no checkpoint to "
                "roll back to (ckpt_dir unset or empty)")
        factor = self.train_cfg.rollback_lr_factor
        if factor < 1.0:
            self._lr_scale *= factor
            self.opt_state["lr_scale"] = torch.tensor(self._lr_scale)

    def _preempt(self):
        """SIGTERM (or any GracefulShutdown signal): checkpoint durably,
        drop a resume marker and raise PreemptionError, which
        ``run_with_restarts`` never retries.  On a mesh every rank gets
        here at the same step, and rank 0 writes both."""
        if self.ckpt_dir is not None:
            self.save(wait=True)
            if self._writes_checkpoints:
                signum = self.shutdown.signum if self.shutdown else None
                write_resume_marker(self.ckpt_dir, self.step,
                                    reason=f"signal {signum}")
        raise PreemptionError(self.step)

    def _stop_flag(self) -> bool:
        """This process's SIGTERM flag."""
        return self.shutdown is not None and self.shutdown.requested

    # -- loop -----------------------------------------------------------------
    def train(self, batches, max_steps: int | None = None,
              fault_injector=None) -> list[dict]:
        """Steps over ``batches`` until they end or ``step`` reaches
        ``max_steps``; ``fault_injector.maybe_fail(step)`` runs before
        each step.  On a raise the steps done so far ride on the
        exception as ``partial_history``."""
        history = []
        try:
            return self._train_loop(batches, history, max_steps,
                                    fault_injector)
        except Exception as exc:
            exc.partial_history = history
            raise

    def _train_loop(self, batches, history, max_steps, fault_injector):
        for batch in batches:
            if max_steps is not None and self.step >= max_steps:
                break
            if self._agreed_stop if self.mesh is not None \
                    else self._stop_flag():
                self._preempt()
            t0 = time.perf_counter()
            if fault_injector is not None:
                fault_injector.maybe_fail(self.step)
            indices = None
            if isinstance(batch, TaggedBatch):
                indices, batch = batch.indices, batch.batch
            # on a mesh, this rank's SIGTERM flag rides the step's reduction
            stop = None if self.mesh is None else self._stop_flag()
            if isinstance(batch, StepPlan):
                self.params, self.opt_state, metrics = self._step_plan(
                    batch, stop)
            elif isinstance(batch, CrystalGraphBatch):
                self.params, self.opt_state, metrics = self._train_step(
                    self.params, self.opt_state, batch.to(self.device),
                    self.step, stop)
            else:
                raise TypeError(f"Trainer.train takes CrystalGraphBatch, "
                                f"StepPlan or TaggedBatch items, got "
                                f"{type(batch).__name__}")
            if indices is not None:
                self._recent_indices.append((self.step, np.asarray(indices)))
            values = _host_values(metrics)
            if stop is not None:
                self._agreed_stop = values.pop("stop") > 0
            loss = values["loss"]
            # a step the scaler skipped (grads_finite 0) left the state
            # untouched: not a fault (DESIGN.md §4)
            skipped = not values.get("grads_finite", 1.0)
            if self.sentinel is not None:
                if self.sentinel.record(loss, scaler_skipped=skipped):
                    self._rollback()
                    continue
            elif not math.isfinite(loss) and not skipped:
                # no sentinel: restore rather than go on poisoned
                if self.maybe_restore():
                    continue
                raise FloatingPointError(
                    f"non-finite loss at step {self.step}")
            self.step += 1
            self.straggler.record(time.perf_counter() - t0)
            self._maybe_refit_cost_model()
            history.append(values)
            if self.ckpt_dir is not None and self.step % self.ckpt_every == 0:
                # only states the sentinel finds healthy, so that every
                # file is a known-good rollback target
                if self.sentinel is None or not self.sentinel.suspicious:
                    self.save()
        return history
