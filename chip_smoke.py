#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths at full width through their public entry
points and holds every hand-written CUDA kernel on them against its plain
PyTorch version:

  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: the kernels compile from ``src/repro_torch/csrc`` (nvcc), and
     the LM kernels' ``-Xptxas -v`` lines are printed (registers, stack,
     spills per kernel) with each source's build time;
  3. kernels: each kernel against its plain version on the card, on the
     inputs of the first training batch and of the largest serving group,
     within ``1e-4 * max(1, max|plain|)``, and both timed with CUDA events
     (the segment sum also beside ``torch.segment_reduce``, the symmetric
     conv's phase B beside a sparse product, the GatedMLP beside its
     composition: ``torch.addmm`` in full f32, two ``layer_norm``s and the
     gate; the convs, the symmetric conv's phase A and the force readouts
     beside theirs: ``index_select`` gathers, the same MLP, the envelope,
     ``torch.segment_reduce``); the wrapper calls as a caller sees them
     and the launches alone (``device_ms``); the split-f32 kernels (the
     convs, phase A, the force readouts, the GatedMLP, and the fused
     feed-forward and flash attention in f32) also
     against the bound of three TF32 products at the TF32 peak and the
     f32 FMA bound, and must give equal bits on a second call with the
     same inputs; the convs also with the
     mirror operands of the undirected store (``pair``, ``pair`` + ``und``)
     and the symmetric conv's two kernels; the bf16 paths of kernels 1
     (D = 64 and the force head's D = 3), 2, 3 (each conv variant), 4a,
     4b, 5, 6 and 7 on the same batches' values as the mixed tiers hand
     them over (bf16 features; kernel 6's messages, 4b's distances and 7's
     LayerNorm parameters f32), within one bf16 rounding (``2**-7 *
     max(1, max|plain|)``, also for the outputs kept in f32: 5's messages,
     4b's virial sums) of their bf16 plain versions, equal bits on two
     calls, bound at the bf16 peak, their f32 kernels timed in turns beside
     them (1 also beside ``torch.segment_reduce`` in bf16, 6 beside a bf16
     CSR ``torch.sparse.mm``); then ragged layouts and edge
     values (for the convs: a row longer than a block's chunk, rows
     straddling tiles, no edge at all, a single row, D = 128; for the force
     readouts at every width: a 700-bond row, rows straddling tiles, a
     crystal with no bonds between two that have them, every row padded,
     crystal slots permuted and crystals interleaved; for phase A at every
     width: 0, 1 and 64 +- 1, 128 +- 1 real rows with self-image pairs;
     the convs, kernels 4a, 4b, 5 and 6, the segment sum and the GatedMLP
     also in bf16;
     for the RBF and Fourier bases at K of 7, 31 and 127: 0, 1, 3, T +- 1
     and 4 T + 3 rows with zero rows amid them; each called twice for
     equal bits, the bases also on the batches' inputs), and batches with
     self-image pairs and singleton undirected entries;
  4. backward: the kernel wrappers' backwards (the convs' backward
     kernel, the recompute, or a gather for the segment sum) against plain
     autograd through ``kernels.ref`` on the card, and whether two
     backward runs give bitwise equal gradients; the convs' backward
     kernel timed against the recompute it replaces, each form at both
     batches (``conv_bwd`` lines);
  5. serve: ``ServeEngine`` / ``BatchedMD`` with 16 replicas, one warm-up
     MD step then counted steps, at ``FAST_FUSED`` (5 steps), at
     ``FAST_PALLAS`` (the unfused Pallas tier: segment sum, GatedMLP, RBF
     and Fourier kernels; 5 steps) and at ``WO_HEAD_PALLAS`` (the same tier
     with the autodiff readout: forces and stress are derivatives of the
     energy through the wrappers' backwards; 2 steps), at
     ``FAST_FUSED_SYM`` (the symmetric half-graph trunk; 5 steps), at
     ``FAST_FUSED_HALF`` (the undirected store; 2 steps) and at the mixed
     tiers ``FAST_FUSED_MIXED`` (5 steps), ``FAST_FUSED_HALF_MIXED``,
     ``FAST_PALLAS_MIXED``, ``FAST_FUSED_SYM_MIXED`` and
     ``FAST_FUSED_VIRIAL_MIXED`` (2 steps each: bf16 operands, f32 sums and
     outputs, on the f32 parameters); the launch counters must show every
     kernel of the path (at a mixed tier every launch through a bf16 C
     entry, ``ops.entry_launch_counts``), the outputs must be finite, and
     one batch through the plain path must agree (the mixed tiers within
     DESIGN.md §4's bound, 3e-2 of the largest value and cosine 0.999,
     also against their f32 configs);
  6. ``FAST_FUSED`` with ``mlp_impl="pallas"``: one forward and backward on
     the first training batch against the plain path, with launch counts;
  7. train: ``Trainer`` over a ``BatchIterator`` of the synthetic dataset
     at batch 128, at ``FAST_FUSED`` (1 + 5 steps), ``FAST_FUSED_VIRIAL``
     (1 + 3), ``FAST_PALLAS`` (1 + 3), ``WO_HEAD_PALLAS`` (1 + 2: a double
     backward through the wrappers), ``FAST_FUSED_SYM`` (1 + 3),
     ``FAST_FUSED_HALF`` (1 + 2), ``FAST_FUSED_HALF_MIXED`` (1 + 2),
     ``FAST_PALLAS_MIXED``, ``FAST_FUSED_SYM_MIXED`` and
     ``FAST_FUSED_VIRIAL_MIXED`` (1 + 2 each; the first batch also against
     the f32 config at §4's bounds) and ``REFERENCE`` (1 + 2, no kernels:
     the paper's baseline), all at ``capacity_for``; beside them
     ``FAST_FUSED`` on ``ladder_for``'s buckets fed synchronously (1 + 3)
     and, through ``Prefetcher(device="cuda")`` (pinned copies on a
     stream of its own), ``FAST_FUSED``, ``FAST_FUSED_SYM`` and
     ``FAST_FUSED_MIXED`` (1 + 5 each), the bucket of every counted step
     reported; the mixed tiers report their loss scale and
     ``grads_finite`` each step; the first
     prefetched batch must equal the synchronous ``.to("cuda")`` batch bit
     for bit and its step's loss that of the same step fed synchronously,
     and the prefetcher's packing time, copy time and the steps' wait for
     it are reported; the launch counters must show every kernel of
     each path, losses and gradient norms must be finite, on the first
     batch the loss and every gradient leaf of a kernels' path must agree
     with its plain path (the mixed tiers: the loss within 3e-2, the
     gradients within 5% relative global norm and cosine 0.999); then the
     time of a step taken apart, the peak
     memory (allocated and reserved), and from one traced step the device
     time of kernel 4b's two kernels (``FAST_FUSED_VIRIAL`` and its mixed
     tier), of the bases, the GatedMLP and the segment sum
     (``FAST_PALLAS``; the last two also at ``FAST_PALLAS_MIXED``), of
     kernels 5 and 6 at ``FAST_FUSED_SYM_MIXED`` and of
     ``embedding_dense_backward`` (the fused tiers, at both capacities);
  8. ``FAST_FUSED_HALF`` computes ``FAST_FUSED``'s function (DESIGN.md
     §5): on the first training batch and one parameter tree every output
     and the loss must agree;
  9. balanced: ``BalancedBatchIterator`` (2 cost-sorted microbatches a
     step, each in its own bucket of ``ladder_for``) through the
     ``Prefetcher`` into ``Trainer._step_plan`` at ``FAST_FUSED`` with live
     cost-model refits every 2 steps (1 + 5 steps), then
     ``FAST_FUSED_MIXED`` (1 + 2, loss scale and ``grads_finite`` each
     step); kernels 2, 3 and 4a launched exactly twice ``PER_FORWARD`` a
     step; on the first plan the summed microbatch gradients within
     ``1e-4 * max(1, max|p|)`` of one batch of the same indices at
     ``capacity_for`` and of the plain path; the refit model must reach
     the iterator; ms per optimizer step and crystals/s beside
     ``FAST_FUSED prefetch``, each microbatch's bucket and real/capacity
     atoms, bonds and angles, the refit coefficients;
 10. runtime: a real SIGTERM at step 3 (async checkpoints every 2 steps)
     must preempt with a resume marker and a valid checkpoint, and the
     restored run must end at step 6 equal bit for bit to an
     uninterrupted one; ``nan@3,nan@4`` with rollback on divergence must
     roll back once, quarantine, train on finitely and leave only files
     that verify; a bit flip in the newest file must make the restore take
     the one before; ``python -m repro_torch.launch.train --balance cost
     --accum 2 --async-ckpt`` must train 8 steps and resume from its own
     checkpoint to 12; checkpoint bytes, sync save, async save (loop
     thread, flush) and restore times are reported;
 11. dp (data parallelism over ``torch.distributed``, ``FAST_FUSED``):
     A. a one-rank NCCL mesh in this process, ``Trainer(mesh=)`` for
     ``grad_reduce`` plain, bucketed and compressed (1 + 3 steps each) in
     turns with the single-device Trainer from the same parameters on the
     same ladder batches, under deterministic algorithms: plain and
     bucketed equal every step's metrics and every state leaf bit for bit,
     compressed reduces the first gradient to its bf16 rounding bit for
     bit and stays within DESIGN.md §4's bounds; the balanced path (2
     plans of 2 microbatches) bit for bit; ms a step of both, and the
     all-reduce's collectives, bytes and device time a step; B. two
     spawned processes sharing the card over gloo (NCCL refuses two ranks
     on one device), a rank's 64 crystals on ``ladder_for(ds, 64)``: run
     1, ``BatchIterator`` shards, bucketed, 1 + 3 steps (the first step
     within ``1e-4 * max(1, |p|)`` of the two shards run one after the
     other in this process); run 2, ``BalancedBatchIterator`` plans of 2
     microbatches (the first plan's summed gradient within 1e-4 relative
     of one batch at ``capacity_for``), 1 + 3 steps; run 3,
     ``elastic_train`` to 5 steps with position 1 dropped at step 2; the
     replicas equal bit for bit after every step, kernels 2, 3 and 4a
     launched exactly ``PER_FORWARD`` a forward on each rank, ms a step,
     the gloo all-reduce's host ms and the peak MiB a rank (two processes
     sharing one card: no scaling); any child's exception, exit or
     timeout raises;
 12. learns: 60 steps at batch 8 at ``FAST_FUSED``, and again at
     ``FAST_FUSED_MIXED``, must bring a held-out batch's loss below 0.6x
     its value before;
 13. lm: llama3-8b at full width and depth with bf16 weights from the
     seed (the CHGNet phases' memory returned first): 4 prompts of 512
     tokens prefilled into a 640-position KV cache, then 16 greedy decode
     steps, on the kernels' path (every layer's MLP through the fused
     feed-forward kernel, exactly 32 launches per prefill and per decode
     step) and on the plain path (no launch); the two teacher-forced on
     the plain path's tokens, every step's logits within DESIGN.md §4's
     bf16 bound (3e-2 of the largest logit, cosine 0.999), greedy token
     agreement reported; both paths timed through ``serve.lm``'s
     ``prefill_step`` / ``decode_step`` in turns (plain, kernels, kernels,
     plain); the feed-forward kernel at the path's shapes (beside the
     plain path's MLP at the same shapes, ``composition_ms``), in f32 at
     full width (M = 4, 16, 128, 256: split f32, beside the plain path's
     cuBLAS f32 MLP), at the edges of its schedule (M = 1, 16, 64, 65,
     129, 2,341) and at ragged shapes, and the flash-attention kernel (on
     no model path: the
     JAX package's prefill runs jnp attention) at (B 4, H 32, S 512, D
     128) and ragged shapes in both dtypes, each against its plain version
     (bf16 at the §4 bound, f32 within 1e-4), kernels and yardsticks timed
     in turns; then llama3-8b cut to 2 layers in f32, kernels' path
     against plain within 1e-4;
 14. eval_serve: ``make_chgnet_eval_serve_step`` at ``FAST_FUSED`` and
     ``FAST_FUSED_SYM`` on the largest serving group's batch and the first
     training batch: one forward's launches, metrics and outputs equal to
     ``eval_step``'s and ``serve_step``'s bit for bit (deterministic
     algorithms), the combined step timed in turns with the two; and
     ``param_count`` of ``FAST_FUSED`` and ``REFERENCE`` within 5% of the
     paper's 429.1K and 412.5K;
 15. lm_train: llama3-8b at full width cut to 2 layers, f32 master
     weights and bf16 compute, 4 x 512 tokens: the gradient at
     ``accum_steps`` 2 against 1 (loss within 3e-2, global norm within
     5%, cosine 0.999), 1 + 5 steps of ``launch.steps.make_lm_train_step``
     on one repeated batch (the loss must fall) and 1 + 2 at ``accum_steps``
     2, ms a step, tokens/s and peak memory; the SMOKE config in f32, one
     step on the card against the same step on the CPU: the parameters
     within 1e-4, the update of every leaf within 2% of lr element by
     element and 1% in norm;
 16. moe: deepseek-moe-16b at full width cut to 2 layers, bf16 weights:
     prefill of 4 x 512 and 16 decode steps, the kernels' path (the shared
     experts on kernel 10) teacher-forced against the plain path at §4's
     bound, both timed through ``serve.lm`` in turns, kernel 10 at the
     shared experts' prefill and decode shapes, the routing (tokens per
     expert, the share kept under capacity), then 1 + 3 training steps
     from f32 master weights; phi3.5-moe at full width, 1 layer, on the
     plain path (no shared expert): prefill + 4 decode steps finite, the
     prefill against the forward at §4's bound, the routing;
 17. qwen110b: qwen1.5-110b at full width (QKV bias) cut to 2 layers,
     bf16: prefill + 8 decode steps, the kernels' path against the plain
     path at §4's bound, both timed, and kernel 10 at D 8192, F 49152
     against its plain version beside the plain path's MLP;
 18. families (ROADMAP item 14d), each at the full width and depth of its
     config with bf16 weights from the seed, 4 prompts and 16 greedy
     decode steps through ``serve.lm`` (``models.api.family_fns``):
     qwen2-vl-2b (28 layers; 512 tokens with M-RoPE positions for a 16 x
     16 image block between text: t fixed, h and w over the grid) and
     zamba2-1.2b (38 Mamba2 layers, the shared block at 6 sites), each
     with the kernels' path (kernel 10 exactly 28 / 6 launches a prefill
     and a decode step) teacher-forced against the plain path at §4's
     bound and both timed in turns; rwkv6-3b (32 layers, 512 tokens) and
     whisper-medium (24 + 24 layers, 1,500 encoder frames, decoding from
     token 0 into a 448-position cache) on their one path (no gated MLP,
     no kernel), timed twice; for all four the decode steps' logits
     against ``forward_train`` over the same tokens at §4's bound (the
     hybrid at 6e-2: its bf16 recurrence against its chunked forward
     differs by more than 3e-2 in JAX at the SMOKE config), gated at full
     depth for qwen2-vl and whisper and at 6 / 2 layers for zamba2 /
     rwkv6, whose seeded weights amplify rounding with depth (recorded at
     full depth, swept over depth; f32 gated at full depth), and ms per
     prefill and decode step, tokens/s, peak memory; kernel 10 at the
     VLM's (D 1536, F 8960) and the hybrid's shared MLP (D 2048, F 8192)
     prefill and decode shapes against its plain version beside the plain
     path's MLP; qwen2-vl at 2 layers and zamba2 at 6 (one site) in f32,
     kernels' path against plain within 1e-4 and decode against forward
     within 1e-3; training at full width with depth cut (qwen2-vl 2,
     zamba2 6 at SSD chunk 128, rwkv6 2, whisper 2 + 2), f32 masters and
     bf16 compute, 4 x 512: every first gradient leaf finite, 1 + 2 steps
     with a falling loss; each SMOKE config's ``lm_loss`` on the card
     against the CPU within 1e-4;
 19. pipeline (GPipe, ``distributed.pipeline.gpipe_apply``): 4 spawned
     processes share the card over gloo (NCCL refuses two ranks on one
     device) on a (1, 4) ("data", "pipe") ``launch.mesh.make_host_mesh``;
     llama3-8b's layers at full width (d 4096, 32 heads, 8 KV heads, F
     14336), 8 of its 32 from the seed, 2 a stage, 8 microbatches of 1 x
     512 hidden states at positions 0..511: the kernels' path in bf16
     (every stage's MLP on kernel 10 at M 512) pipelined against the same
     8 layers run one after another in one process at §4's bound (3e-2 *
     max(1, max|p|), cosine 0.999; bit equality reported), against the
     plain path at §4; the same in f32 within 1e-4; each stage's
     gradients of sum(out ** 2) on the plain path in f32 against the
     sequential ones within 1e-4 relative global norm, cosine 0.999999;
     kernel 10 exactly M * L / S = 16 launches a rank (fill and drain
     steps run no stage); every rank's outputs equal; ms of the pipelined
     and the sequential forward on CUDA events beside ``bubble_fraction(4,
     8)`` (four processes time-share one card: no speed-up can show), the
     hop's bytes and ms, peak MiB a rank;
 20. launch: ``launch.steps.build_cell``'s train, prefill and decode
     steps run for real on llama3-8b at full width cut to 2 layers, at
     SHAPES' sequence lengths with the batch cut (train_4k 1 of 256, f32
     masters, the default accum; prefill_32k 1 of 32, bf16, kernel 10 at
     M 32,768; decode_32k 8 of 128 against a 32,768-position cache, bf16,
     kernel 10 at M 8), their inputs checked against the cell's ``meta``
     structures, each timed on CUDA events with peak MiB beside the
     roofline's compute and memory terms of the same cut cell at one chip
     (``analysis.roofline``; no collective term at one chip) and the
     measured share of the larger; prefill and decode logits and caches
     on the kernels' path against the plain path at §4; ``python -m
     repro_torch.launch.dryrun --all`` in process (82 records: 66 ok, 16
     skip), ``torch.cuda.memory_allocated()`` unchanged; the dry run's
     CHGNet cell at one rank (``FAST_FS_HEAD``, one step on 8 crystals at
     the per-device capacities 512 / 12,288 / 16,384), its peak MiB beside
     the record's argument bytes.  Kernel 10 at the three new shapes joins
     the ``kernels`` line.

``FAST_PALLAS``, ``WO_HEAD_PALLAS``, ``FUSED_MLP_PALLAS``,
``FAST_PALLAS_MIXED``, ``FAST_FUSED_SYM_MIXED`` and
``FAST_FUSED_VIRIAL_MIXED`` are labels of this script for tiers that are
no named config of the package.  bf16
products outside the kernels (cuBLAS) sum in f32
(``allow_bf16_reduced_precision_reduction`` off), as TF32 is off for f32
ones.  Prints
``{"serve": ...}``, ``{"train": ...}``, ``{"dp": ...}``, ``{"lm": ...}``,
``{"eval_serve": ...}``, ``{"lm_train": ...}``, ``{"moe": ...}``,
``{"qwen110b": ...}``, ``{"families": ...}``, ``{"pipeline": ...}``,
``{"launch": ...}`` and ``{"kernels": [...]}``
JSON lines and, last, ``{"ok": true, "device": {...}}``.  Any failure
raises and exits nonzero; without CUDA it exits nonzero before printing a
result.

    python3 chip_smoke.py [--seed 0] [--profile DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch.batching import (  # noqa: E402
    BatchCapacities,
    CapacityLadder,
    batch_crystals,
    capacity_for,
    ladder_for,
)
from repro_torch.configs import chgnet_mptrj  # noqa: E402
from repro_torch.core import basis, chgnet, heads  # noqa: E402
from repro_torch.core.neighbors import Crystal, build_graph  # noqa: E402
from repro_torch.core.graph import FIELDS  # noqa: E402
from repro_torch.data import (  # noqa: E402
    BalancedBatchIterator,
    BatchIterator,
    Prefetcher,
    SyntheticConfig,
    build_device_batch,
    generate_crystal,
    make_dataset,
)
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    GRAD_REDUCE,
    all_reduce_grads,
    bucket_plan,
    init_data_mesh,
)
from repro_torch.distributed import pipeline as gpipe  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import LogicalMesh, make_host_mesh  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_cell,
    lm_grads,
    make_lm_train_step,
)
from repro_torch.models import (  # noqa: E402
    hybrid,
    layers,
    rwkv,
    transformer,
)
from repro_torch.models.api import family_fns  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.optim.adam import adam_init  # noqa: E402
from repro_torch.optim.grad import global_norm  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.precision import resolve_policy, scale_loss  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    AsyncCheckpointWriter,
    ChaosMonkey,
    ChaosSchedule,
    DeviceDropInjector,
    GracefulShutdown,
    PreemptionError,
    corrupt_newest_checkpoint,
    elastic_train,
    latest_valid_step,
    list_checkpoints,
    read_resume_marker,
    save_checkpoint,
    verify_checkpoint,
)
from repro_torch.serve import BatchedMD, ServeEngine  # noqa: E402
from repro_torch.serve import lm  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    TrainConfig,
    Trainer,
    apply_grads,
    chgnet_loss_fn,
    grads_of,
    make_chgnet_accum_step_fns,
    make_chgnet_eval_serve_step,
    make_chgnet_step_fns,
    params_on,
)

REPLICAS = 16
STEPS = 5
# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# bf16 on the tensor cores, dense (the LM kernels' bf16 operands)
PEAK_BF16_FLOPS = 989e12
# TF32 on the tensor cores, dense: the split-f32 (3xTF32) kernels issue
# three TF32 products per f32 product
PEAK_TF32_FLOPS = 494.7e12
CSRC = "src/repro_torch/csrc"
SOURCE = f"{CSRC}/message_passing.cu"
TPU_DIR = "src/repro/kernels"
TPU_FILE = f"{TPU_DIR}/fused_message_passing.py"
TRAIN_BATCH = chgnet_mptrj.BATCH_SIZE

# the tiers of this slice (labels of this script, not package configs)
_PALLAS = dict(mlp_impl="pallas", agg_impl="pallas")
FAST_PALLAS = chgnet_mptrj.FAST_FS_HEAD.with_(**_PALLAS)
WO_HEAD_PALLAS = chgnet_mptrj.FAST_WO_HEAD.with_(**_PALLAS)
FUSED_MLP_PALLAS = chgnet_mptrj.FAST_FUSED.with_(mlp_impl="pallas")
# the tiers whose kernels run in bf16 since kernels 1, 4b, 5, 6 and 7 have
# bf16 paths: the unfused Pallas tier, the fused symmetric trunk and the
# fused bond virial at "mixed"
FAST_PALLAS_MIXED = FAST_PALLAS.with_(precision="mixed")
FAST_FUSED_SYM_MIXED = chgnet_mptrj.FAST_FUSED_SYM.with_(precision="mixed")
FAST_FUSED_VIRIAL_MIXED = chgnet_mptrj.FAST_FUSED_VIRIAL.with_(
    precision="mixed")
# the C entries of the kernels with a bf16 path: a run at a bf16 compute
# dtype must launch none of these f32 entries (ops.entry_launch_counts)
F32_ENTRIES_WITH_BF16 = ("atom_conv_fwd", "bond_conv_fwd", "sym_msg_fwd",
                         "sym_accum_fwd", "force_readout_fwd",
                         "force_virial_fwd", "segment_sum_fwd",
                         "gated_mlp_fwd")

# kernel launches per forward, by wrapper; every other counter must stay 0
# (also FAST_FUSED_HALF and the mixed tiers FAST_FUSED_MIXED and
# FAST_FUSED_HALF_MIXED, whose launches are the bf16 kernels'; the _MIXED
# labels below launch as their f32 tiers, through the bf16 entries)
PER_FORWARD = {"fused_atom_conv": 4, "fused_bond_conv": 3,
               "fused_force_readout": 1}
# FAST_FUSED_VIRIAL: the force+virial wrapper launches two kernels
PER_FORWARD_VIRIAL = {"fused_atom_conv": 4, "fused_bond_conv": 3,
                      "fused_force_virial_readout": 2}
# FAST_PALLAS: the bases once; the GatedMLP in 4 atom convs, 3 bond convs
# and 3 angle updates; the segment sum in the 7 convs and the force head
# (the energy and stress heads pool per crystal with their own scatter)
PER_FORWARD_PALLAS = {"fused_rbf": 1, "fused_fourier": 1,
                      "fused_gated_mlp_packed": 10, "fused_segment_sum": 8}
# WO_HEAD_PALLAS: no force head; the backward launches no kernel
PER_FORWARD_WO_HEAD = dict(PER_FORWARD_PALLAS, fused_segment_sum=7)
# FUSED_MLP_PALLAS: the fused convs subsume the MLP and the aggregation;
# the angle updates and the bases take the unfused tier's kernels
PER_FORWARD_FUSED_MLP = dict(PER_FORWARD, fused_rbf=1, fused_fourier=1,
                             fused_gated_mlp_packed=3)
# FAST_FUSED_SYM: the 3 bond convs are symmetric ones, two kernels each
# (phase A sym_msg, phase B sym_accum); FAST_FUSED_HALF launches as
# FAST_FUSED (PER_FORWARD), its convs with the mirror operands
PER_FORWARD_SYM = {"fused_atom_conv": 4, "fused_sym_bond_conv": 6,
                   "sym_msg": 3, "sym_accum": 3, "fused_force_readout": 1}


# the LM phase: llama3-8b at full width and depth, bf16 weights; 4 prompts
# of 512 tokens into a 640-position cache, then 16 greedy decode steps
LM_ARCH = "llama3-8b"
LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_DECODE = 4, 512, 640, 16
LM_TPU_DIR = "src/repro/kernels"
# LM training: llama3-8b at full width, 2 layers, f32 master weights and
# bf16 compute, batches of 4 x 512 tokens; the MoE family at full width
# (deepseek-moe-16b, 2 layers; phi3.5-moe, 1 layer) and qwen1.5-110b at
# full width, 2 layers
LM_TRAIN_LAYERS, LM_TRAIN_STEPS = 2, 5
MOE_ARCH, PHI_ARCH, QWEN_ARCH = ("deepseek-moe-16b", "phi3.5-moe-42b-a6.6b",
                                 "qwen1.5-110b")
MOE_TRAIN_STEPS, PHI_DECODE, QWEN_DECODE = 3, 4, 8


def plain_config(cfg):
    """The same function with no kernel: unfused convs, scatter sums and
    the packed GatedMLP in plain PyTorch."""
    return cfg.with_(conv_impl="unfused", agg_impl="scatter",
                     mlp_impl="packed" if cfg.mlp_impl == "pallas"
                     else cfg.mlp_impl)


def check_bf16_entries(name: str, entries: dict, counts: dict) -> None:
    """At a bf16 compute dtype, every kernel launch with a bf16 path went
    through its bf16 C entry: no f32 entry of ``F32_ENTRIES_WITH_BF16``
    ran, and the bf16 entries' launches add up to the wrappers' counts
    (the bases run in f32, kernel 4b's crystal sum reads f32 partials)."""
    f32 = {e: n for e, n in entries.items() if e in F32_ENTRIES_WITH_BF16}
    if f32:
        raise RuntimeError(f"{name}: f32 entries launched at a bf16 compute "
                           f"dtype: {f32}")
    bf16 = sum(n for e, n in entries.items() if "_bf16_" in e)
    want = sum(n for w, n in counts.items()
               if w not in ("fused_rbf", "fused_fourier",
                            "fused_sym_bond_conv"))
    want -= entries.get("virial_crystal_sum", 0)
    if bf16 != want or not bf16:
        raise RuntimeError(f"{name}: {bf16} bf16 entry launches, expected "
                           f"{want} ({entries}, wrappers {counts})")


def check_launches(name: str, counts: dict, per_forward: dict,
                   forwards: int) -> None:
    """Every wrapper launched ``per_forward`` times per forward, every other
    wrapper never."""
    for fn, n in counts.items():
        want = per_forward.get(fn, 0) * forwards
        if n != want:
            raise RuntimeError(f"{name}: {fn} launched {n} times in "
                               f"{forwards} forwards, expected {want}")


def bwd_launch_counts() -> dict[str, int]:
    """The convs' backward kernel launches since the last reset, by
    wrapper."""
    return {fn.__name__: fn.bwd_launches for fn in ops.BWD_WRAPPERS}


def check_bwd_launches(name: str, counts: dict, per_forward: dict,
                       backwards: int) -> None:
    """The convs' backward kernel taken by every one of ``backwards``
    first-order backwards, once for each of the conv's ``per_forward``
    launches of a forward: no conv backward of the main path recomputed."""
    for fn, n in counts.items():
        want = per_forward.get(fn, 0) * backwards
        if n != want:
            raise RuntimeError(f"{name}: {fn}'s backward kernel launched "
                               f"{n} times in {backwards} backwards, "
                               f"expected {want}")


def _time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event samples of ``inner`` back-to-back
    calls each, per call, after warm-up."""
    return _time_turns([fn], reps, inner)[0]


def _time_turns(fns, reps: int = 20, inner: int = 10) -> list[float]:
    """``_time_ms`` of each function, their samples taken in turns (one
    sample of each function, then the next round), so that a kernel and
    its yardsticks see the same state of the card."""
    for fn in fns:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    samples = [[] for _ in fns]
    for _ in range(reps):
        for fn, out in zip(fns, samples):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            stop.record()
            stop.synchronize()
            out.append(start.elapsed_time(stop) / inner)
    return [statistics.median(s) for s in samples]


# spin cycles queued before a device-time sample, ~3 ms: longer than the
# host takes to enqueue a sample's wrapper calls
SPIN_CYCLES = 5_000_000


def _time_device(fn, reps: int = 20, inner: int = 10) -> float:
    """The device time of ``fn``'s launches per call: median over ``reps``
    CUDA-event samples of ``inner`` calls queued behind a spin kernel
    (``torch.cuda._sleep``), so that the card runs them back to back
    whatever the host's cost of a call (``_time_ms`` times the calls as a
    caller sees them, host cost included where it exceeds the kernel's)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / inner)
    return statistics.median(samples)


def _slots(n: int) -> int:
    """Crystal slots of a group of n replicas: the next power of two."""
    return 1 << max(0, (n - 1).bit_length())


def _bound(flops: float, nbytes: float,
           peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _check_close(name: str, got, want, rel: float = 1e-4
                 ) -> tuple[float, float]:
    """Max abs error of ``got`` against ``want`` and the tolerance it met,
    ``rel * max(1, max|want|)`` (1e-4 unless a caller states another);
    raises if it did not.  Tuples are checked element by element and
    report the largest error and tolerance."""
    if isinstance(got, tuple):
        pairs = [_check_close(f"{name}[{i}]", g, w, rel)
                 for i, (g, w) in enumerate(zip(got, want, strict=True))]
        return max(p[0] for p in pairs), max(p[1] for p in pairs)
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite values")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    tol = rel * max(1.0, want.abs().max().item() if want.numel() else 0.0)
    if not err <= tol:
        raise RuntimeError(f"{name}: max abs error {err} > {tol}")
    return err, tol


def _equal(a, b) -> bool:
    """Bitwise equality of two outputs, tensors or tuples of them."""
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b, strict=True))
    return torch.equal(a, b)


def _bf16_gap(name: str, got, want, rel: float = 3e-2) -> tuple:
    """(max abs error, tolerance ``rel * max(1, max|want|)``, cosine, both
    within DESIGN.md §4's bound: the error within the tolerance and the
    cosine at least 0.999) of bf16 outputs (bf16 rounds at other places on
    the two sides; ``rel`` 3e-2 unless a caller states another); raises
    only on a shape mismatch or a non-finite value."""
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite values")
    err = (got - want).abs().max().item()
    tol = rel * max(1.0, want.abs().max().item())
    cos = torch.nn.functional.cosine_similarity(
        got.flatten(), want.flatten(), dim=0).item()
    return err, tol, cos, err <= tol and cos >= 0.999


def _check_bf16(name: str, got, want, rel: float = 3e-2
                ) -> tuple[float, float, float]:
    """``_bf16_gap``'s (error, tolerance, cosine); raises if they miss the
    bound."""
    err, tol, cos, ok = _bf16_gap(name, got, want, rel)
    if not ok:
        raise RuntimeError(f"{name}: max abs error {err} (tolerance {tol}), "
                           f"cosine {cos} (at least 0.999)")
    return err, tol, cos


def _check_round_bf16(name: str, got, want) -> tuple[float, float]:
    """A bf16 kernel against its bf16 plain version (both f32 inside,
    rounded to bf16 once): within one bf16 rounding of the output,
    ``2**-7 * max(1, max|want|)`` (the two sum in another order, so a
    value near a rounding boundary may round the other way); raises if
    not."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise RuntimeError(f"{name}: dtypes {got.dtype}, {want.dtype}, "
                           "expected bfloat16")
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite values")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    tol = 2.0 ** -7 * max(1.0, want.abs().max().item() if want.numel()
                          else 0.0)
    if not err <= tol:
        raise RuntimeError(f"{name}: max abs error {err} > {tol}")
    return err, tol


def _to_bf16(args) -> tuple:
    return tuple(a.to(torch.bfloat16) if torch.is_tensor(a)
                 and a.is_floating_point() else a for a in args)


def _to_f32(args) -> tuple:
    return tuple(a.float() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def _check_bf16_path(name: str, got, want) -> tuple[float, float]:
    """A bf16 path against its plain version on the same bf16 operands:
    the bf16 outputs within one bf16 rounding (``_check_round_bf16``), the
    outputs the path keeps in f32 (kernel 5's messages, kernel 4b's virial
    sums) at the same tolerance, ``2**-7 * max(1, max|want|)``; a tuple is
    checked output by output."""
    if isinstance(got, tuple):
        pairs = [_check_bf16_path(f"{name}[{i}]", g, w)
                 for i, (g, w) in enumerate(zip(got, want, strict=True))]
        return max(p[0] for p in pairs), max(p[1] for p in pairs)
    if got.dtype == torch.bfloat16 or want.dtype == torch.bfloat16:
        return _check_round_bf16(name, got, want)
    if got.dtype != torch.float32 or want.dtype != torch.float32:
        raise RuntimeError(f"{name}: dtypes {got.dtype}, {want.dtype}, "
                           "expected float32")
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite values")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    tol = 2.0 ** -7 * max(1.0, want.abs().max().item() if want.numel()
                          else 0.0)
    if not err <= tol:
        raise RuntimeError(f"{name}: max abs error {err} > {tol}")
    return err, tol


# the wrappers whose kernels have a bf16 path, by launch counter
BF16_COUNTERS = ("fused_atom_conv", "fused_bond_conv", "fused_force_readout",
                 "fused_force_virial_readout", "sym_msg", "sym_accum",
                 "fused_segment_sum", "fused_gated_mlp_packed")


def bf16_cases(cases) -> list[dict]:
    """The bf16 paths of kernels 1, 2, 3, 4a, 4b, 5, 6 and 7 (the mixed
    tiers) from their split-f32 (or f32) cases on the same batch: each
    float operand as the mixed path hands it over (``c["bf16_args"]``:
    kernel 6's messages, 4b's distances and 7's LayerNorm parameters stay
    f32; by default every float operand rounded to bf16), held to the bf16
    plain version (``_check_bf16_path``: within one bf16 rounding) and
    called twice for equal bits; bound by the flops at the bf16 peak and
    the bytes with bf16 tables (int32 ids, the f32 operands and outputs at
    4 bytes: ``c["bf16_bytes"]``); the f32 kernel on the same values in f32
    timed in turns beside it (``f32_ms``, ``f32_device_ms``); the launch
    plan at 2-byte operands.  Kernels 4a and 4b's wrappers widen x_hat to
    f32 inside the timed call.  Kernel 1 keeps its ``torch.segment_reduce``
    yardstick in bf16 and kernel 6 its sparse product, with a bf16 CSR
    matrix (``c["bf16_library"]``)."""
    out = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c in cases:
        counter = c.get("counter", c["wrapper"].__name__)
        if counter not in BF16_COUNTERS:
            continue
        args = c["bf16_args"] if "bf16_args" in c else _to_bf16(c["args"])
        twin_args = _to_f32(args)
        base, _, variant = c["name"].partition("[")
        name = base.replace("_fwd", "_bf16_fwd") + (f"[{variant}"
                                                    if variant else "")
        wrapper = c["wrapper"]
        dim = c["shape"]["dim"]
        plan = None
        if counter == "fused_gated_mlp_packed":
            plan = ops.gated_mlp_plan(dim, c["shape"]["rows"], sms,
                                      2)._asdict()
        elif counter == "sym_msg":
            plan = sym_plan_row(dim, c["shape"]["real_und_angles"],
                                c["shape"]["und_angles"], itemsize=2)
        elif "plan" in c:
            # the partition is the f32 plan's; the stages take fewer bytes
            mode = "force" if "force" in c["name"] else c["name"][:4]
            bf = ops.conv_plan(mode, dim, 1 << 30, sms, itemsize=2)
            plan = dict(c["plan"], smem=bf.smem,
                        blocks_per_sm=bf.blocks_per_sm)
        row = dict(
            name=name, counter=counter, primary=c.get("primary", True),
            path=c.get("path", "FAST_FUSED") + "_MIXED", wrapper=wrapper,
            plain=c["plain"], args=args, check=_check_bf16_path,
            repeat=True, peak=PEAK_BF16_FLOPS,
            twin=lambda w=wrapper, a=twin_args: w(*a),
            replaces=c["replaces"], flops=c["flops"],
            bytes=c.get("bf16_bytes", 2 * c.get("float_elems", 0)
                        + 4 * c.get("int_elems", 0)),
            shape=c["shape"])
        if plan is not None:
            row["plan"] = plan
        if c.get("source"):
            row["source"] = c["source"]
        if c.get("bf16_library"):
            # a yardstick that rounds elsewhere: held to DESIGN.md §4's
            # bound only
            row.update(library=c["bf16_library"], library_check=_check_bf16)
        out.append(row)
    return out


def conv_composition(parts, env, mlp, offsets, n_real: int):
    """A conv as PyTorch calls, a yardstick timed beside the kernel and
    never called on a path: the real edges' rows gathered with
    ``index_select`` (``parts``, ``env``: (table, row ids or None for the
    edge's own row)), ``torch.addmm`` in full f32, two ``layer_norm``s,
    the gate and the envelope factors, then ``torch.segment_reduce`` over
    the CSR offsets."""
    w, b, lns, lnb = mlp
    d = w.shape[1] // 2
    offs64 = offsets.long()
    parts = [(t, None if i is None else i[:n_real].long()) for t, i in parts]
    env = [(t, None if i is None else i[:n_real].long()) for t, i in env]

    def rows(t, i):
        return t[:n_real] if i is None else t.index_select(0, i)

    def run():
        y = torch.addmm(b, torch.cat([rows(t, i) for t, i in parts], dim=1),
                        w)
        core, gate = (torch.nn.functional.layer_norm(
            y[:, h], (d,), lns[h], lnb[h], 1e-5)
            for h in (slice(None, d), slice(d, None)))
        m = torch.nn.functional.silu(core) * torch.sigmoid(gate)
        for t, i in env:
            m = m * rows(t, i)
        return torch.segment_reduce(m, "sum", offsets=offs64, axis=0)
    return run


def readout_composition(e, x_hat, mlp, offsets, n_real: int, dist=None,
                        crystal_offsets=None):
    """Kernel 4 as PyTorch calls, a yardstick timed beside the kernel and
    never called on a path: ``torch.addmm`` in full f32, ``silu``, the
    product with w2, the x_hat weighting and ``torch.segment_reduce`` over
    the atom offsets; with ``dist`` (kernel 4b) also the outer product and
    a ``segment_reduce`` over the crystals' bond offsets."""
    w1, b1, w2, b2 = mlp
    offs64 = offsets.long()

    def run():
        e_r, x_r = e[:n_real], x_hat[:n_real]
        n = torch.nn.functional.silu(torch.addmm(b1, e_r, w1)) @ w2 + b2
        forces = torch.segment_reduce(n * x_r, "sum", offsets=offs64, axis=0)
        if dist is None:
            return forces
        outer = (x_r[:, :, None] * x_r[:, None, :]).reshape(-1, 9)
        raw = torch.segment_reduce((n * dist[:n_real, None]) * outer, "sum",
                                   offsets=crystal_offsets, axis=0)
        return forces, raw.reshape(-1, 3, 3)
    return run


def sym_composition(v, e, a_u, e_b, mlp, ctr, du1, du2, n_real: int):
    """Kernel 5 as PyTorch calls, a yardstick timed beside the kernel and
    never called on a path: the real rows' ``index_select`` gathers, the e
    add, ``torch.addmm`` in full f32 with the folded W (K = 3D), two
    ``layer_norm``s, the gate and the envelope."""
    w, b, lns, lnb = mlp
    d = w.shape[1] // 2
    w23 = torch.cat([w[:d], w[d:2 * d] + w[2 * d:3 * d], w[3 * d:]])
    i0, i1, i2 = (t[:n_real].long() for t in (ctr, du1, du2))

    def run():
        x = torch.cat([v.index_select(0, i0),
                       e.index_select(0, i1) + e.index_select(0, i2),
                       a_u[:n_real]], dim=1)
        y = torch.addmm(b, x, w23)
        core, gate = (torch.nn.functional.layer_norm(
            y[:, h], (d,), lns[h], lnb[h], 1e-5)
            for h in (slice(None, d), slice(d, None)))
        m = torch.nn.functional.silu(core) * torch.sigmoid(gate)
        return m * e_b.index_select(0, i1) * e_b.index_select(0, i2)
    return run


def _bf16_sparse_mm(spmat, msg):
    """Kernel 6's bf16 yardstick, ``torch.sparse.mm`` of the incidence
    matrix in bf16 by phase A's messages rounded to bf16 (a different
    rounding: the messages are rounded before the sum).  Never called on
    a path."""
    a, m = spmat.to(torch.bfloat16), msg.to(torch.bfloat16)
    return lambda: torch.sparse.mm(a, m)


def sym_plan_row(dim: int, n_real: int, n_rows: int,
                 itemsize: int = 4) -> dict:
    """The launch plan of kernel 5 on this card (``ops.conv_plan("sym")``,
    at operands of ``itemsize`` bytes) and how its blocks stride over this
    batch's real rows."""
    plan = ops.conv_plan("sym", dim, n_rows, torch.cuda.get_device_properties(
        0).multi_processor_count, itemsize)
    tiles = -(-n_real // plan.tm)
    return dict(plan._asdict(), tiles=tiles,
                busy_blocks=min(plan.grid, tiles),
                max_block_tiles=-(-tiles // plan.grid))


def conv_plan_row(mode: str, dim: int, offsets) -> dict:
    """The launch plan of a reducing kernel on this card (the convs, the
    force readouts: ``ops.conv_plan``) and how its partition spreads this
    batch's edges over the blocks."""
    n_rows = offsets.shape[0] - 1
    plan = ops.conv_plan(mode, dim, n_rows, torch.cuda.get_device_properties(
        0).multi_processor_count)
    spans = [hi - lo for _, _, lo, hi in ops.conv_chunks(offsets, plan)]
    return dict(plan._asdict(), busy_blocks=sum(x > 0 for x in spans),
                max_block_edges=max(spans),
                tiles=sum(-(-x // plan.tm) for x in spans))


def _io(floats: int, ints: int) -> dict:
    """A case's bytes from its float and int32 elements (f32: 4 bytes
    each); ``bf16_cases`` counts the floats at 2 bytes."""
    return dict(bytes=4 * (floats + ints), float_elems=floats,
                int_elems=ints)


def kernel_cases(params, cfg, batch) -> list[dict]:
    """Each kernel's wrapper, plain version and inputs on one real packed
    batch, with the work it must do there: flops and bytes at the batch's
    real counts (each table row the real edges reach read once, the CSR
    offsets read whole, each output row written once, padded rows
    included)."""
    with torch.inference_mode():
        v, e, a, e_a, e_b, vec, dist, _, _ = chgnet.embed(params, cfg,
                                                          batch)
    blk = params["blocks"][0]
    am, bm = blk["atom_mlp"], blk["bond_mlp"]
    (l0, l1) = params["force_head"]["mlp"]
    center = batch.bond_center[batch.angle_ij]
    x_hat = heads.bond_unit_vectors(vec, dist)
    n_atoms, dim = v.shape
    n_bonds = e.shape[0]
    n_crys = batch.num_crystals
    real_atoms = int(batch.atom_mask.sum())
    real_bonds = int(batch.bond_offsets[-1])
    real_angles = int(batch.angle_offsets[-1])
    f = 4  # bytes per f32 / int32 element
    readout_flops = (2 * real_bonds * dim * dim + 2 * real_bonds * dim
                     + 6 * real_bonds)
    readout_io = _io(real_bonds * (dim + 3) + dim * dim + 2 * dim + 1
                     + n_atoms * 3, n_atoms + 1)
    readout_bytes = readout_io["bytes"]
    bond_shape = {"atoms": n_atoms, "bonds": n_bonds,
                  "real_bonds": real_bonds, "dim": dim}
    fmlp = (l0["w"], l0["b"], l1["w"], l1["b"])
    # the crystals' bond ranges: bond_crystal is nondecreasing over the
    # real bonds (the packer's layout)
    cry_offs = torch.searchsorted(
        batch.bond_crystal[:real_bonds].contiguous(),
        torch.arange(n_crys + 1, device=e.device, dtype=torch.int32))
    amlp = (am["w"], am["b"], am["ln_scale"], am["ln_bias"])
    bmlp = (bm["w"], bm["b"], bm["ln_scale"], bm["ln_bias"])
    return [
        dict(name="atom_conv_fwd", wrapper=ops.fused_atom_conv,
             plain=ref.fused_atom_conv_ref,
             args=(v, e, e_a) + amlp + (batch.bond_center, batch.bond_nbr,
                                        batch.bond_offsets),
             split=True, composition=conv_composition(
                 [(v, batch.bond_center), (v, batch.bond_nbr), (e, None)],
                 [(e_a, None)], amlp, batch.bond_offsets, real_bonds),
             plan=conv_plan_row("atom", dim, batch.bond_offsets),
             replaces=f"{TPU_FILE}:252",
             flops=2 * real_bonds * 3 * dim * 2 * dim,
             **_io(real_atoms * dim + 2 * real_bonds * dim
                   + 3 * dim * 2 * dim + 6 * dim + n_atoms * dim,
                   2 * real_bonds + n_atoms + 1),
             shape=bond_shape),
        dict(name="bond_conv_fwd", wrapper=ops.fused_bond_conv,
             plain=ref.fused_bond_conv_ref,
             args=(v, e, a, e_b) + bmlp + (batch.angle_ij, batch.angle_ik,
                                           center, batch.angle_offsets),
             split=True, composition=conv_composition(
                 [(v, center), (e, batch.angle_ij), (e, batch.angle_ik),
                  (a, None)], [(e_b, batch.angle_ij), (e_b, batch.angle_ik)],
                 bmlp, batch.angle_offsets, real_angles),
             plan=conv_plan_row("bond", dim, batch.angle_offsets),
             replaces=f"{TPU_FILE}:488",
             flops=2 * real_angles * 4 * dim * 2 * dim,
             **_io(real_atoms * dim + 2 * real_bonds * dim
                   + real_angles * dim + 4 * dim * 2 * dim + 6 * dim
                   + n_bonds * dim, 3 * real_angles + n_bonds + 1),
             shape={"atoms": n_atoms, "bonds": n_bonds,
                    "angles": a.shape[0], "real_angles": real_angles,
                    "dim": dim}),
        dict(name="force_readout_fwd", wrapper=ops.fused_force_readout,
             plain=ref.fused_force_readout_ref,
             args=(e, x_hat) + fmlp + (batch.bond_center, batch.bond_offsets,
                                       n_atoms),
             split=True, composition=readout_composition(
                 e, x_hat, fmlp, batch.bond_offsets, real_bonds),
             plan=conv_plan_row("force", dim, batch.bond_offsets),
             replaces=f"{TPU_FILE}:737", flops=readout_flops,
             **readout_io, shape=bond_shape),
        # + per bond: n*d and 9 products of 2 factors; + the crystal sum.
        # The mixed path hands kernel 4b bf16 e, x_hat and weights and the
        # f32 distances; it writes bf16 forces and f32 sums
        dict(name="force_virial_fwd", wrapper=ops.fused_force_virial_readout,
             plain=ref.fused_force_virial_readout_ref,
             path="FAST_FUSED_VIRIAL",
             args=(e, x_hat, dist) + fmlp + (batch.bond_center,
                                             batch.bond_crystal,
                                             batch.bond_offsets, n_atoms,
                                             n_crys),
             bf16_args=_to_bf16((e, x_hat)) + (dist,) + _to_bf16(fmlp)
             + (batch.bond_center, batch.bond_crystal, batch.bond_offsets,
                n_atoms, n_crys),
             bf16_bytes=2 * readout_io["float_elems"]
             + 4 * readout_io["int_elems"]
             + f * (real_bonds + n_atoms + 9 * n_crys),
             split=True, composition=readout_composition(
                 e, x_hat, fmlp, batch.bond_offsets, real_bonds, dist,
                 cry_offs.long()),
             plan=conv_plan_row("force", dim, batch.bond_offsets),
             replaces=f"{TPU_FILE}:758",
             flops=readout_flops + 19 * real_bonds + 9 * n_atoms,
             bytes=readout_bytes + f * (real_bonds + n_atoms + 9 * n_crys),
             shape=dict(bond_shape, crystals=n_crys)),
    ]


def sym_kernel_cases(params, batch) -> list[dict]:
    """The kernels of the undirected store and the symmetric trunk on one
    real packed batch, at the inputs ``FAST_FUSED_HALF`` / ``FAST_FUSED_SYM``
    give them: the atom conv with ``pair`` (e^a at Eu rows) and with
    ``pair`` + ``und`` (e too), the bond conv with ``pair`` (e^b at Eu rows
    through ``pair[angle_*]``), and phases A (``sym_msg``) and B
    (``sym_accum``) of the symmetric bond conv.  Phase A writes the real
    dedup rows only, so it is compared there; phase B reads the plain phase
    A's messages.  Work at the real counts: each table row the real
    edges reach read once (Eu tables: the real Eu rows), ids read once per
    real edge, outputs written once (phase A: the real rows only)."""
    half = chgnet_mptrj.FAST_FUSED_HALF
    sym = chgnet_mptrj.FAST_FUSED_SYM
    with torch.inference_mode():
        v, e_h, a_h, e_a, e_b = chgnet.embed(params, half, batch)[:5]
        _, e_u, a_u = chgnet.embed(params, sym, batch)[:3]
    # ids outside inference mode: the backward phase saves them
    ij, ik = batch.und_angle_ij.long(), batch.und_angle_ik.long()
    ctr = batch.bond_center[ij]
    du1, du2 = batch.bond_pair[ij], batch.bond_pair[ik]
    blk = params["blocks"][0]
    am, bm = blk["atom_mlp"], blk["bond_mlp"]
    amlp = (am["w"], am["b"], am["ln_scale"], am["ln_bias"])
    bmlp = (bm["w"], bm["b"], bm["ln_scale"], bm["ln_bias"])
    n_atoms, dim = v.shape
    n_bonds, n_eu = batch.bond_cap, batch.und_cap
    real_atoms = int(batch.atom_mask.sum())
    real_bonds = int(batch.bond_offsets[-1])
    real_angles = int(batch.angle_offsets[-1])
    real_eu = int(batch.und_mask.sum())
    n_incid = int(batch.sym_offsets[-1])
    real_au = n_incid // 2
    f = 4
    w_bytes = 6 * dim  # b, ln_scale, ln_bias
    pair = batch.bond_pair
    atom_ids = (batch.bond_center, batch.bond_nbr, batch.bond_offsets)
    atom_flops = 2 * real_bonds * 3 * dim * 2 * dim
    atom_floats = real_atoms * dim + 3 * dim * 2 * dim + w_bytes \
        + n_atoms * dim
    atom_ints = 3 * real_bonds + n_atoms + 1
    center = batch.bond_center[batch.angle_ij]
    sym_args = (v, e_u, a_u, e_b) + bmlp + (ctr, du1, du2,
                                             batch.sym_offsets)
    with torch.inference_mode():
        msg = ref.sym_msg_ref(*sym_args[:11])
        # the mixed path's: phase A of the bf16 operands, f32 messages
        msg_bf = ref.sym_msg_ref(*_to_bf16(sym_args[:11]))
    accum_args = (msg, batch.sym_rep, batch.sym_dest, batch.sym_offsets,
                  n_eu)
    # the incidences as an (Eu, Au) matrix, a self-image row's two
    # incidences summed into one entry of 2
    spmat = torch.sparse_coo_tensor(
        torch.stack([batch.sym_dest[:n_incid], batch.sym_rep[:n_incid]]),
        torch.ones(n_incid, device=msg.device),
        size=(n_eu, msg.shape[0]),
        check_invariants=True).coalesce().to_sparse_csr()
    sparse_bf16 = _bf16_sparse_mm(spmat, msg_bf)
    return [
        dict(name="atom_conv_fwd[pair]", counter="fused_atom_conv",
             path="FAST_FUSED_HALF",
             wrapper=lambda *a: ops.fused_atom_conv(*a, pair=pair),
             plain=lambda *a: ref.fused_atom_conv_ref(*a, pair),
             args=(v, e_h, e_a) + amlp + atom_ids, split=True,
             composition=conv_composition(
                 [(v, batch.bond_center), (v, batch.bond_nbr), (e_h, None)],
                 [(e_a, pair)], amlp, batch.bond_offsets, real_bonds),
             plan=conv_plan_row("atom", dim, batch.bond_offsets),
             replaces=f"{TPU_FILE}:252", flops=atom_flops,
             **_io(atom_floats + real_bonds * dim + real_eu * dim,
                   atom_ints),
             shape={"atoms": n_atoms, "bonds": n_bonds, "und": n_eu,
                    "real_bonds": real_bonds, "real_und": real_eu,
                    "dim": dim}),
        dict(name="atom_conv_fwd[pair+und]", counter="fused_atom_conv",
             path="FAST_FUSED_SYM",
             wrapper=lambda *a: ops.fused_atom_conv(*a, pair=pair,
                                                    und_features=True),
             plain=lambda *a: ref.fused_atom_conv_ref(*a, pair, True),
             args=(v, e_u, e_a) + amlp + atom_ids, split=True,
             composition=conv_composition(
                 [(v, batch.bond_center), (v, batch.bond_nbr), (e_u, pair)],
                 [(e_a, pair)], amlp, batch.bond_offsets, real_bonds),
             plan=conv_plan_row("atom", dim, batch.bond_offsets),
             replaces=f"{TPU_FILE}:252", flops=atom_flops,
             **_io(atom_floats + 2 * real_eu * dim, atom_ints),
             shape={"atoms": n_atoms, "bonds": n_bonds, "und": n_eu,
                    "real_bonds": real_bonds, "real_und": real_eu,
                    "dim": dim}),
        dict(name="bond_conv_fwd[pair]", counter="fused_bond_conv",
             path="FAST_FUSED_HALF",
             wrapper=lambda *a: ops.fused_bond_conv(*a, pair=pair),
             plain=lambda *a: ref.fused_bond_conv_ref(*a, pair),
             args=(v, e_h, a_h, e_b) + bmlp + (batch.angle_ij,
                                                batch.angle_ik, center,
                                                batch.angle_offsets),
             split=True, composition=conv_composition(
                 [(v, center), (e_h, batch.angle_ij), (e_h, batch.angle_ik),
                  (a_h, None)],
                 [(e_b, pair[batch.angle_ij.long()]),
                  (e_b, pair[batch.angle_ik.long()])],
                 bmlp, batch.angle_offsets, real_angles),
             plan=conv_plan_row("bond", dim, batch.angle_offsets),
             replaces=f"{TPU_FILE}:488",
             flops=2 * real_angles * 4 * dim * 2 * dim,
             **_io(real_atoms * dim + real_bonds * dim + real_eu * dim
                   + real_angles * dim + 4 * dim * 2 * dim + w_bytes
                   + n_bonds * dim, 5 * real_angles + n_bonds + 1),
             shape={"atoms": n_atoms, "bonds": n_bonds, "und": n_eu,
                    "angles": batch.angle_cap, "real_angles": real_angles,
                    "dim": dim}),
        # phase A's GEMM runs at K = 3D (w2 + w3 added once per call)
        dict(name="sym_msg_fwd", counter="sym_msg", path="FAST_FUSED_SYM",
             wrapper=lambda *a: ops.sym_msg(*a)[:real_au],
             plain=lambda *a: ref.sym_msg_ref(*a[:11])[:real_au],
             args=sym_args, split=True,
             composition=sym_composition(v, e_u, a_u, e_b, bmlp, ctr, du1,
                                         du2, real_au),
             plan=sym_plan_row(dim, real_au, a_u.shape[0]),
             replaces=f"{TPU_FILE}:1002",
             flops=2 * real_au * 3 * dim * 2 * dim,
             bytes=f * (real_atoms * dim + 2 * real_eu * dim + real_au * dim
                        + 3 * dim * 2 * dim + w_bytes + 3 * real_au + 1
                        + real_au * dim),
             # bf16 operands, the messages written in f32
             bf16_bytes=2 * (real_atoms * dim + 2 * real_eu * dim
                             + real_au * dim + 3 * dim * 2 * dim + w_bytes)
             + f * (3 * real_au + 1 + real_au * dim),
             shape={"atoms": n_atoms, "und": n_eu, "und_angles":
                    a_u.shape[0], "real_und_angles": real_au, "dim": dim}),
        dict(name="sym_accum_fwd", counter="sym_accum",
             path="FAST_FUSED_SYM", wrapper=ops.sym_accum,
             plain=ref.sym_accum_ref, args=accum_args,
             library=lambda: torch.sparse.mm(spmat, msg),
             source=f"{CSRC}/segment_sum.cu", replaces=f"{TPU_FILE}:1112",
             flops=n_incid * dim,
             bytes=f * (real_au * dim + n_incid + n_eu + 1 + n_eu * dim),
             # the mixed path: phase A's f32 messages in, bf16 sums out
             bf16_args=(msg_bf,) + accum_args[1:] + (torch.bfloat16,),
             bf16_bytes=f * (real_au * dim + n_incid + n_eu + 1)
             + 2 * n_eu * dim, bf16_library=sparse_bf16,
             shape={"und": n_eu, "real_und": real_eu,
                    "incidences": n_incid, "dim": dim}),
    ]


def sym_backward_cases(cases) -> list[dict]:
    """The backward cases of the undirected store and the symmetric trunk,
    from ``sym_kernel_cases``: the convs with their mirror operands and the
    whole symmetric bond conv (``_SymBondConv``: phases A and B forward,
    the recompute backward).  Their gradients must be bitwise repeatable."""
    by_counter = {c["counter"]: c for c in cases}
    rep, dest, offs = by_counter["sym_accum"]["args"][1:4]
    convs = [dict(c, require_bitwise=True) for c in cases
             if c["counter"] in ("fused_atom_conv", "fused_bond_conv")]
    return convs + [dict(
        name="fused_sym_bond_conv", counter="fused_sym_bond_conv",
        wrapper=ops.fused_sym_bond_conv, plain=ref.fused_sym_bond_conv_ref,
        args=by_counter["sym_msg"]["args"][:11] + (rep, dest, offs),
        require_bitwise=True)]


def sym_edge_batches(seed: int) -> dict:
    """Packed batches of the undirected store's edge cases, on the card: a
    one-atom crystal (every bond a self-image pair, du1 == du2 on its
    angles) beside a small one, in capacities four times the real counts
    (a long all-padded tail); and crystals whose per-center neighbor cap
    breaks pair symmetry, so some undirected entries are singletons
    (tests/test_bond_store.py:112, :167)."""
    rng = np.random.default_rng(seed)
    small = Crystal(lattice=np.eye(3) * 4.2 + rng.normal(0, .05, (3, 3)),
                    frac_coords=rng.random((5, 3)),
                    atomic_numbers=rng.integers(1, 60, 5))
    one = Crystal(lattice=np.eye(3) * 2.8, frac_coords=np.zeros((1, 3)),
                  atomic_numbers=np.array([8]))
    out = {}
    cs = [one, small]
    gs = [build_graph(c) for c in cs]
    out["self-image, padded tail"] = batch_crystals(cs, gs, BatchCapacities(
        4 * 6, 4 * sum(g.num_bonds for g in gs),
        4 * sum(g.num_angles for g in gs)), num_crystal_slots=4)
    cs = [Crystal(lattice=np.eye(3) * 4.0 + rng.normal(0, .05, (3, 3)),
                  frac_coords=rng.random((8, 3)),
                  atomic_numbers=rng.integers(1, 60, 8)) for _ in range(4)]
    gs = [build_graph(c, max_nbr_per_atom=3, cap_mode="per_center")
          for c in cs]
    und = sum(g.num_undirected for g in gs)
    if 2 * und == sum(g.num_bonds for g in gs):
        raise RuntimeError("the capped crystals kept pair symmetry")
    out["singleton entries"] = batch_crystals(cs, gs, BatchCapacities(
        40, sum(g.num_bonds for g in gs) + 16,
        sum(g.num_angles for g in gs) + 16, und_bonds=und + 8))
    return {k: b.to("cuda") for k, b in out.items()}


def sym_edge_cases(params, f, ids, seed: int) -> int:
    """The mirror-operand convs and the symmetric conv's kernels against
    their plain versions on the edge batches of ``sym_edge_batches`` and on
    random layouts: a self-image dedup row (du1 == du2), an Eu row with no
    incidences, a padded tail, every dedup row padded, and several rows
    per block; then phase A (kernel 5) at every width of
    ``ops.CONV_WIDTHS`` with 0, 1, 63, 65, 127 and 129 real rows (its
    64-row tiles, and 128 +- 1), self-image rows among them, each called
    twice for equal bits.  Each also on its bf16 path: the edge batches'
    cases through ``bf16_cases``, the layouts' whole conv and phase A at
    every width (f32 messages), against the plain versions of the same
    bf16 operands.  Returns the number of cases checked."""
    n = 0
    for label, batch in sym_edge_batches(seed).items():
        cases = sym_kernel_cases(params, batch)
        for c in cases:
            _check_close(f"{c['name']} on {label}", c["wrapper"](*c["args"]),
                         c["plain"](*c["args"]))
            n += 1
        for c in bf16_cases(cases):
            _check_bf16_path(f"{c['name']} on {label}",
                             c["wrapper"](*c["args"]), c["plain"](*c["args"]))
            n += 1
    rng = np.random.default_rng(seed + 1)
    for a_rows, eu, au, n_real, d, per_block in (
            (7, 13, 24, 17, 8, 32), (30, 200, 400, 0, 64, 32),
            (50, 300, 500, 333, 64, 5), (9, 40, 64, 64, 16, 1)):
        args = _sym_layout(rng, f, ids, a_rows, eu, au, n_real, d)
        got = ops.fused_sym_bond_conv(*args, msg_block=per_block)
        want = ref.fused_sym_bond_conv_ref(*args)
        _check_close(f"sym_bond_conv case {n}", got, want)
        if got[-1].any():
            raise RuntimeError("sym_accum: an Eu row with no incidences "
                               "must be 0")
        msg = ops.sym_msg(*args[:11], args[13], block_rows=per_block)
        _check_close(f"sym_msg case {n}", msg[:n_real],
                     ref.sym_msg_ref(*args[:11])[:n_real])
        bf_args = _to_bf16(args)
        _check_round_bf16(f"sym_bond_conv bf16 case {n}",
                          ops.fused_sym_bond_conv(*bf_args),
                          ref.fused_sym_bond_conv_ref(*bf_args))
        n += 3
    # kernel 5 at every width, real dedup counts at and around its 64-row
    # tiles, a sixth of the rows self-image pairs (du1 == du2)
    for d in ops.CONV_WIDTHS:
        for n_real in (0, 1, 63, 65, 127, 129):
            args = _sym_layout(rng, f, ids, 11, 90, n_real + 20, n_real, d)
            got = ops.sym_msg(*args[:11], args[13])[:n_real]
            if not torch.equal(got, ops.sym_msg(*args[:11],
                                                args[13])[:n_real]):
                raise RuntimeError(f"sym_msg D = {d}, {n_real} real rows: "
                                   "two calls on the same inputs differ")
            _check_close(f"sym_msg D = {d}, {n_real} real rows", got,
                         ref.sym_msg_ref(*args[:11])[:n_real])
            # the bf16 path: f32 messages of bf16 operands
            bf_args = _to_bf16(args[:11])
            got = ops.sym_msg(*bf_args, args[13])[:n_real]
            if not torch.equal(got, ops.sym_msg(*bf_args,
                                                args[13])[:n_real]):
                raise RuntimeError(f"sym_msg bf16 D = {d}, {n_real} real "
                                   "rows: two calls on the same inputs "
                                   "differ")
            _check_bf16_path(f"sym_msg bf16 D = {d}, {n_real} real rows",
                             got, ref.sym_msg_ref(*bf_args)[:n_real])
            n += 2
    return n


def _sym_layout(rng, f, ids, a_rows: int, eu: int, au: int, n_real: int,
                d: int) -> tuple:
    """``fused_sym_bond_conv``'s arguments on a random layout: ``au`` dedup
    rows of which the first ``n_real`` are real, a seventh of them (at
    least one) self-image pairs, their incidences sorted by destination
    into the (Eu + 1,) offsets."""
    du1 = rng.integers(0, eu - 1, au).astype(np.int32)
    du2 = rng.integers(0, eu - 1, au).astype(np.int32)
    du2[: max(1, n_real // 7)] = du1[: max(1, n_real // 7)]
    du1[n_real:] = du2[n_real:] = 0
    dest = np.concatenate([du1[:n_real], du2[:n_real]])
    rep = np.concatenate([np.arange(n_real, dtype=np.int32)] * 2)
    order = np.argsort(dest, kind="stable")
    sym_dest = np.zeros(2 * au, np.int32)
    sym_rep = np.zeros(2 * au, np.int32)
    sym_dest[:2 * n_real] = dest[order]
    sym_rep[:2 * n_real] = rep[order]
    offs = np.searchsorted(sym_dest[:2 * n_real], np.arange(eu + 1))
    cuda = [torch.from_numpy(x.astype(np.int32)).cuda()
            for x in (du1, du2, sym_rep, sym_dest, offs)]
    return (f(a_rows, d), f(eu, d), f(au, d), f(eu, d),
            f(4 * d, 2 * d, scale=0.1), f(2 * d), f(2 * d).abs() + 0.5,
            f(2 * d), ids(a_rows, au), *cuda)


def tier_kernel_cases(params, cfg, batch) -> list[dict]:
    """The unfused tier's four kernels on one real packed batch, at the
    inputs the ``FAST_PALLAS`` path gives them (``cfg`` is a config with the
    same parameter tree, used for the embedding): the segment sum at the
    bond convs' shape, the widest (its atom-conv and force-head shapes are
    extra cases), the GatedMLP at the bond convs' and angle updates'
    shape (its atom-conv shape extra), the RBF over every bond and the
    Fourier basis over every angle.  The segment sum reads only the real
    edges, so its work is counted at the real counts; the others compute
    every row, so theirs is counted at the capacities.  Flops: the GatedMLP
    counts its GEMM and bias only; the bases count a sine or cosine as one
    operation (16 per RBF element, 3 per Fourier element)."""
    with torch.inference_mode():
        v, e, a, e_a, _e_b, vec, dist, _, _ = chgnet.embed(params, cfg,
                                                           batch)
        theta = basis.compute_geometry(batch)[3]
        bmask = batch.bond_mask[:, None]
        center = batch.bond_center[batch.angle_ij]
        x_bond = torch.cat([ref.gather_rows(v, center),
                            ref.gather_rows(e, batch.angle_ij),
                            ref.gather_rows(e, batch.angle_ik), a], dim=-1)
        x_atom = torch.cat([ref.gather_rows(v, batch.bond_center),
                            ref.gather_rows(v, batch.bond_nbr), e], dim=-1)
        x_hat = heads.bond_unit_vectors(vec, dist) * bmask
        e_a = e_a * bmask
    blk = params["blocks"][0]
    n_atoms, dim = v.shape
    n_bonds, n_ang = e.shape[0], a.shape[0]
    real_bonds = int(batch.bond_offsets[-1])
    real_angles = int(batch.angle_offsets[-1])
    f = 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def seg_case(name, values, ids, offsets, rows, real, primary):
        d = values.shape[1]
        offs64 = offsets.long()
        vb = values.to(torch.bfloat16)
        return dict(
            name=name, primary=primary, wrapper=ops.fused_segment_sum,
            plain=ref.sorted_segment_sum_ref, path="FAST_PALLAS",
            args=(values, ids, offsets, rows),
            library=lambda: torch.segment_reduce(
                values[:real], "sum", offsets=offs64, axis=0),
            bf16_args=(vb, ids, offsets, rows),
            bf16_library=lambda: torch.segment_reduce(
                vb[:real], "sum", offsets=offs64, axis=0),
            source=f"{CSRC}/segment_sum.cu",
            replaces=f"{TPU_DIR}/fused_segment_sum.py:99",
            flops=real * d, bytes=f * (real * d + rows + 1 + rows * d),
            bf16_bytes=2 * (real * d + rows * d) + f * (rows + 1),
            shape={"edges": values.shape[0], "real_edges": real,
                   "rows": rows, "dim": d})

    def mlp_case(name, x, p, primary):
        m, d_in = x.shape
        d2 = p["w"].shape[1]

        def composition(x=x, p=p, d=d2 // 2):
            y = torch.addmm(p["b"], x, p["w"])
            core, gate = (torch.nn.functional.layer_norm(
                y[:, h], (d,), p["ln_scale"][h], p["ln_bias"][h], 1e-5)
                for h in (slice(None, d), slice(d, None)))
            return torch.nn.functional.silu(core) * torch.sigmoid(gate)

        return dict(
            name=name, primary=primary, wrapper=ops.fused_gated_mlp_packed,
            plain=ref.fused_gated_mlp_ref, path="FAST_PALLAS",
            args=(x, p["w"], p["b"], p["ln_scale"], p["ln_bias"]),
            # the mixed path: x, w and b bf16, the LayerNorm parameters
            # the f32 tree's
            bf16_args=_to_bf16((x, p["w"], p["b"])) + (p["ln_scale"],
                                                       p["ln_bias"]),
            composition=composition, split=True,
            plan=ops.gated_mlp_plan(d2 // 2, m, sms)._asdict(),
            source=f"{CSRC}/gated_mlp.cu",
            replaces=f"{TPU_DIR}/fused_gated_mlp.py:52",
            flops=2 * m * d_in * d2 + m * d2,
            bytes=f * (m * d_in + d_in * d2 + 3 * d2 + m * d2 // 2),
            bf16_bytes=2 * (m * d_in + d_in * d2 + d2 + m * d2 // 2)
            + f * 2 * d2,
            shape={"rows": m, "d_in": d_in, "dim": d2 // 2})

    k_rbf, k_four = params["rbf_freqs"].shape[0], cfg.num_fourier
    return [
        seg_case("segment_sum_fwd", a, batch.angle_ij, batch.angle_offsets,
                 n_bonds, real_angles, True),
        seg_case("segment_sum_fwd[atom conv]", e_a, batch.bond_center,
                 batch.bond_offsets, n_atoms, real_bonds, False),
        seg_case("segment_sum_fwd[force head, D=3]", x_hat,
                 batch.bond_center, batch.bond_offsets, n_atoms, real_bonds,
                 False),
        mlp_case("gated_mlp_fwd", x_bond, blk["bond_mlp"], True),
        mlp_case("gated_mlp_fwd[atom conv]", x_atom, blk["atom_mlp"], False),
        dict(name="rbf_fwd", primary=True, wrapper=ops.fused_rbf,
             plain=ref.fused_rbf_ref,
             args=(dist, params["rbf_freqs"], cfg.r_cut_atom,
                   cfg.envelope_p),
             source=f"{CSRC}/basis.cu", repeat=True,
             plan=ops.basis_plan("rbf", n_bonds, k_rbf, sms)._asdict(),
             replaces=f"{TPU_DIR}/fused_rbf.py:36",
             flops=16 * n_bonds * k_rbf,
             bytes=f * (n_bonds + k_rbf + n_bonds * k_rbf),
             shape={"bonds": n_bonds, "basis": k_rbf}),
        dict(name="fourier_fwd", primary=True, wrapper=ops.fused_fourier,
             plain=ref.fused_fourier_ref, args=(theta, k_four),
             source=f"{CSRC}/basis.cu", repeat=True,
             plan=ops.basis_plan("fourier", n_ang, k_four, sms)._asdict(),
             replaces=f"{TPU_DIR}/fused_fourier.py:39",
             flops=3 * n_ang * k_four, bytes=f * (n_ang + n_ang * k_four),
             shape={"angles": n_ang, "basis": k_four}),
    ]


def kernel_phase(cases) -> list[dict]:
    """Each kernel against its plain version, both timed (the kernel's
    wrapper calls as a caller sees them, ``ms``, and its launches alone,
    ``device_ms``), beside the one
    PyTorch call that computes the same function where there is one
    (``library``) and, for kernel 10, the plain LM path's composition of
    the same MLP (``composition``; for kernel 7, ``torch.addmm`` in full
    f32, the two ``layer_norm``s and the gate; for kernels 2 and 3,
    ``conv_composition``; for 4, ``readout_composition``; for 5,
    ``sym_composition``): yardsticks only, the port never calls them on a
    kernels' path.  A split-f32 case (``split``: kernels 2, 3, 4, 5, 7 and
    11 in f32) is bound by three TF32 products per f32 product at the TF32
    peak, reports the f32 FMA bound beside it (``bound_fma_ms``), and must
    give the same bits on a second call.  A bf16 case of kernels 1-7
    (``bf16_cases``) is bound at the bf16 peak and times the f32 kernel
    on the same values in turns with it (``twin``).  A conv case
    also reports its launch plan and how its partition spreads the batch
    (``plan``).  The kernel and its yardsticks, which read the same
    inputs, are timed in turns; the plain version, whose f32 copies and
    intermediates sweep the L2 cache, on its own after them (the median
    of 5 samples of 2 calls: it takes 30-100x the kernel's time)."""
    rows = []
    with torch.inference_mode():
        for c in cases:
            kernel, plain, args = c["wrapper"], c["plain"], c["args"]
            check = c.get("check", _check_close)
            got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err, tol = check(c["name"], got, want)[:2]
            repeat = c.get("split") or c.get("repeat")
            if repeat and not _equal(kernel(*args), got):
                raise RuntimeError(f"{c['name']}: two calls on the same "
                                   "inputs differ")
            fns = [lambda: kernel(*args)]
            for key in ("library", "composition"):
                if c.get(key):
                    c.get(f"{key}_check", check)(f"{c['name']} {key}",
                                                 c[key](), want)
                    fns.append(c[key])
            if c.get("twin"):
                fns.append(c["twin"])
            times = _time_turns(fns)
            k_ms = times[0]
            dev_ms = _time_device(fns[0])
            # the plain version (30-100x slower): fewer, shorter samples
            p_ms = _time_ms(lambda: plain(*args), 5, 2)
            yard = iter(times[1:])
            lib_ms = next(yard) if c.get("library") else None
            comp_ms = next(yard) if c.get("composition") else None
            twin_ms = next(yard) if c.get("twin") else None
            if c.get("split"):
                # the work the split-f32 kernel issues: three TF32
                # products per f32 product
                bound_ms, bound_by = _bound(3 * c["flops"], c["bytes"],
                                            PEAK_TF32_FLOPS)
            else:
                bound_ms, bound_by = _bound(c["flops"], c["bytes"],
                                            c.get("peak", PEAK_F32_FLOPS))
            rows.append({
                "name": c["name"], "route": "cuda",
                "source": c.get("source", SOURCE),
                "replaces": c["replaces"],
                "wrapper": c.get("counter", kernel.__name__),
                "max_abs_err": err, "tolerance": tol, "ms": k_ms,
                "device_ms": dev_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms, "flops": c["flops"],
                "bytes": c["bytes"], "shape": c["shape"],
            })
            lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
            if c.get("composition"):
                rows[-1]["composition_ms"] = comp_ms
                lib += f", composition {comp_ms:.4f} ms"
            if c.get("plan"):
                rows[-1]["plan"] = c["plan"]
            if c.get("repeat"):
                rows[-1]["bitwise_repeatable"] = True
                lib += ", two calls give equal bits"
            if c.get("twin"):
                # the f32 kernel on the same values, in turns
                twin_dev = _time_device(c["twin"])
                rows[-1].update(f32_ms=twin_ms, f32_device_ms=twin_dev)
                lib += (f", f32 kernel {twin_ms:.4f} ms (device "
                        f"{twin_dev:.4f})")
            if c.get("split"):
                # the same work as f32 FMAs on the CUDA cores, and the
                # bitwise repeat checked above
                fma_ms = _bound(c["flops"], c["bytes"])[0]
                rows[-1].update(bound_fma_ms=fma_ms, bitwise_repeatable=True)
                lib += (f", FMA bound {fma_ms:.4f} ms, two calls give "
                        "equal bits")
            print(f"kernel {c['name']}: max|k-p| {err:.3e} (tolerance "
                  f"{tol:.3e}), kernel {k_ms:.4f} ms (device {dev_ms:.4f}), "
                  f"plain {p_ms:.4f} ms"
                  f"{lib}, bound {bound_ms:.4f} ms ({bound_by}), shape "
                  f"{c['shape']}", flush=True)
    return rows


def backward_phase(cases, seed: int) -> list[dict]:
    """Each wrapper's backward against plain autograd through its
    ``kernels.ref`` version on the same CUDA tensors: the gradients of
    ``sum(out * r)`` for every float input, ``r`` from a seeded
    generator.  Each backward runs twice; whether the two runs give
    bitwise equal gradients is reported, not required (a sum whose CUDA
    order may vary from run to run can sit in a backward)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for c in cases:
        idx = [i for i, x in enumerate(c["args"])
               if torch.is_tensor(x) and x.is_floating_point()]

        def grads(fn, r=None):
            args = list(c["args"])
            for i in idx:
                args[i] = args[i].detach().clone().requires_grad_()
            out = fn(*args)
            outs = out if isinstance(out, tuple) else (out,)
            if r is None:
                r = [torch.randn(o.shape, generator=gen, device="cuda")
                     for o in outs]
            total = sum((o * ri).sum() for o, ri in zip(outs, r))
            return torch.autograd.grad(total, [args[i] for i in idx]), r

        got, r = grads(c["wrapper"])
        again, _ = grads(c["wrapper"], r)
        want, _ = grads(c["plain"], r)
        torch.cuda.synchronize()
        err, tol = _check_close(f"{c['name']} backward", tuple(got),
                                tuple(want))
        bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
        if c.get("require_bitwise") and not bitwise:
            raise RuntimeError(f"{c['name']} backward: two runs gave "
                               "different gradients")
        wrapper = c.get("counter", c["wrapper"].__name__)
        rows.append({"name": c["name"], "wrapper": wrapper,
                     "inputs": len(idx), "max_abs_err": err,
                     "tolerance": tol, "bitwise_repeatable": bitwise})
        print(f"backward {c['name']}: {len(idx)} input grads, "
              f"max|k-p| {err:.3e} (tolerance {tol:.3e}), bitwise "
              f"repeatable: {bitwise}", flush=True)
    return rows


def conv_backward_rows(cases, batch: str) -> list[dict]:
    """The convs' backward kernel (``conv_bwd_kernel``, a first-order
    backward) timed against the chunked recompute it replaces, which the
    wrappers take where the backward is itself differentiated
    (``create_graph``), on each conv case of ``cases`` (the directed store
    and the mirror operands): ms a backward of one retained graph, in
    turns (host cost included: the recompute reads ``offsets[-1]`` to the
    host), and the kernel's launches alone behind a spin (``device_ms``).
    Bound: three products of 2 E K 2D in split f32 at the TF32 peak, or
    twice the forward's bytes (the operands read, their cotangents
    written), whichever is larger."""
    rows = []
    for c in cases:
        counter = c.get("counter", getattr(c["wrapper"], "__name__", ""))
        if counter not in ("fused_atom_conv", "fused_bond_conv"):
            continue
        args = list(c["args"])
        idx = [i for i, x in enumerate(args)
               if torch.is_tensor(x) and x.is_floating_point()]
        for i in idx:
            args[i] = args[i].detach().clone().requires_grad_()
        wrt = [args[i] for i in idx]
        out = c["wrapper"](*args)
        r = torch.randn_like(out)

        def kernel():
            return torch.autograd.grad(out, wrt, r, retain_graph=True)

        def recompute():
            return torch.autograd.grad(out, wrt, r, create_graph=True)

        wrapper = getattr(ops, counter)
        n0 = wrapper.bwd_launches
        got = kernel()
        if wrapper.bwd_launches != n0 + 1:
            raise RuntimeError(f"{c['name']}: the backward did not take "
                               "the kernel")
        want = [g.detach() for g in recompute()]
        if wrapper.bwd_launches != n0 + 1:
            raise RuntimeError(f"{c['name']}: the create-graph backward "
                               "took the kernel")
        # each cotangent's error over its largest element, the limit of
        # tests/test_torch_conv_bwd_cuda.py
        rel = max(((k - p).abs().max() / p.abs().max().clamp_min(1e-30))
                  .item() for k, p in zip(got, want) if p.numel())
        if not rel <= 1e-4:
            raise RuntimeError(f"{c['name']} at the {batch} batch: the "
                               f"backward kernel is {rel:.2e} of the "
                               "recompute's largest element off it")
        del got, want
        n0 = wrapper.bwd_launches
        ms, plain_ms = _time_turns([kernel, recompute], reps=10, inner=5)
        device_ms = _time_device(kernel, reps=10, inner=5)
        taken = wrapper.bwd_launches - n0
        bound, by = _bound(3 * 3 * c["flops"], 2 * c["bytes"],
                           PEAK_TF32_FLOPS)
        row = {"name": c["name"].replace("_fwd", "_bwd"), "batch": batch,
               "wrapper": counter, "max_rel_err": rel,
               "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "kernel_backwards": taken,
               "shape": c["shape"]}
        rows.append(row)
        print(f"conv_bwd {row['name']} {batch}: {ms:.4f} ms (device "
              f"{device_ms:.4f}), recompute {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}); rel err {rel:.2e}; {taken} kernel "
              "backwards", flush=True)
        del out, wrt, args
    return rows


def edge_case_phase(params, seed: int) -> int:
    """Each kernel against its plain version on ragged CSR layouts: a
    padded tail, unaligned rows without padding, every edge padded, and
    several rows per block (``block_rows``, which the convs accept and no
    longer use); the force+virial kernel also with an empty crystal slot;
    then the convs' partition and tile edges (``conv_edge_cases``), the
    force readouts' (``readout_edge_cases``), the unfused tier's cases
    (``tier_edge_cases``) and those of the undirected store and the
    symmetric trunk (``sym_edge_cases``).  Returns the number of cases
    checked."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy(
            rng.normal(0, scale, shape).astype(np.float32)).cuda()

    def ids(high, n):
        return torch.from_numpy(
            rng.integers(0, high, n).astype(np.int32)).cuda()

    def csr(rows, n_edges, n_real):
        seg = np.zeros(n_edges, np.int32)
        seg[:n_real] = np.sort(rng.integers(0, rows, n_real))
        offs = np.searchsorted(seg[:n_real], np.arange(rows + 1))
        return (torch.from_numpy(seg).cuda(),
                torch.from_numpy(offs.astype(np.int32)).cuda())

    def mlp(d_in, d):
        return (f(d_in, 2 * d, scale=0.1), f(2 * d),
                f(2 * d).abs() + 0.5, f(2 * d))

    n = 0
    with torch.inference_mode():
        for rows, n_edges, d, n_real, per_block in (
                (16, 200, 32, 180, 1), (9, 64, 64, 64, 3), (8, 32, 16, 0, 1),
                (40, 700, 8, 650, 7)):
            seg, offs = csr(rows, n_edges, n_real)
            args = (f(rows, d), f(n_edges, d), f(n_edges, d)) \
                + mlp(3 * d, d) + (seg, ids(rows, n_edges), offs)
            _check_close(f"atom_conv case {n}", ops.fused_atom_conv(
                *args, block_rows=per_block), ref.fused_atom_conv_ref(*args))
            xh = f(n_edges, 3)
            fargs = (f(n_edges, d), xh / xh.norm(dim=1, keepdim=True),
                     f(d, d, scale=0.1), f(d, scale=0.1),
                     f(d, 1, scale=0.1), f(1, scale=0.1), seg, offs, rows)
            _check_close(f"force_readout case {n}", ops.fused_force_readout(
                *fargs, block_rows=per_block),
                ref.fused_force_readout_ref(*fargs))
            # crystals own contiguous atom ranges, slot 1 stays empty
            n_crys = 4
            atom_cry = np.sort(rng.choice([0, 2, 3], rows)).astype(np.int32)
            cry = torch.from_numpy(atom_cry).cuda()[seg.long()]
            cry[n_real:] = 0
            vargs = fargs[:2] + (f(n_edges).abs() + 0.5,) + fargs[2:7] \
                + (cry, offs, rows, n_crys)
            _check_close(f"force_virial case {n}",
                         ops.fused_force_virial_readout(
                             *vargs, block_rows=per_block),
                         ref.fused_force_virial_readout_ref(*vargs))
            n += 3
        for atoms, bonds, n_ang, d, n_real, per_block in (
                (10, 48, 300, 32, 260, 32), (6, 17, 40, 16, 40, 1),
                (5, 12, 24, 8, 0, 32), (30, 400, 900, 64, 880, 5)):
            seg, offs = csr(bonds, n_ang, n_real)
            args = (f(atoms, d), f(bonds, d), f(n_ang, d), f(bonds, d)) \
                + mlp(4 * d, d) + (seg, ids(bonds, n_ang), ids(atoms, n_ang),
                                   offs)
            _check_close(f"bond_conv case {n}", ops.fused_bond_conv(
                *args, block_rows=per_block), ref.fused_bond_conv_ref(*args))
            n += 1
        n += conv_edge_cases(f, ids, mlp, seed)
        n += readout_edge_cases(f, seed)
        n += tier_edge_cases(f, ids, csr)
        n += sym_edge_cases(params, f, ids, seed)
    torch.cuda.synchronize()
    return n


def conv_edge_cases(f, ids, mlp, seed: int) -> int:
    """The split-f32 convs (kernels 2 and 3), directed and with their
    mirror operands, against their plain versions on layouts at the edges
    of their partition and tiles: one row longer than a chunk (700
    edges), rows straddling tiles, every row empty with no edge, no real
    edge before a padded tail, a single row, and D = 128 (64-edge tiles).
    Each runs in f32 and with its operands rounded to bf16 (the bf16
    path, within one bf16 rounding of its plain version), twice: the two
    calls must give equal bits.  Returns the number of cases checked."""
    rng = np.random.default_rng(seed + 2)
    layouts = (
        ("one row of 700 edges", [700, 3, 0, 5], 20, 64),
        ("rows straddling tiles", rng.integers(0, 300, 12).tolist(), 5, 32),
        ("every row empty", [0] * 6, 0, 16),
        ("no real edge, padded tail", [0] * 6, 40, 8),
        ("a single row", [300], 0, 64),
        ("D = 128", rng.integers(0, 90, 30).tolist(), 17, 128))
    n = 0
    for label, lens, tail, d in layouts:
        rows, n_real = len(lens), sum(lens)
        n_edges = n_real + tail
        seg = np.zeros(n_edges, np.int32)
        seg[:n_real] = np.repeat(np.arange(rows), lens)
        offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        seg, offs = (torch.from_numpy(x).cuda() for x in (seg, offs))
        eu = n_edges // 2 + 1
        pair, pair_b = ids(eu, n_edges), ids(eu, rows)
        atoms = 7
        atom = (seg, ids(rows, n_edges), offs)
        bond = (seg, ids(rows, n_edges), ids(atoms, n_edges), offs)
        cases = (
            ("atom_conv", ops.fused_atom_conv, ref.fused_atom_conv_ref,
             (f(rows, d), f(n_edges, d), f(n_edges, d)) + mlp(3 * d, d)
             + atom, {}, ()),
            ("atom_conv[pair]", ops.fused_atom_conv, ref.fused_atom_conv_ref,
             (f(rows, d), f(n_edges, d), f(eu, d)) + mlp(3 * d, d) + atom,
             {"pair": pair}, (pair,)),
            ("atom_conv[pair+und]", ops.fused_atom_conv,
             ref.fused_atom_conv_ref,
             (f(rows, d), f(eu, d), f(eu, d)) + mlp(3 * d, d) + atom,
             {"pair": pair, "und_features": True}, (pair, True)),
            ("bond_conv", ops.fused_bond_conv, ref.fused_bond_conv_ref,
             (f(atoms, d), f(rows, d), f(n_edges, d), f(rows, d))
             + mlp(4 * d, d) + bond, {}, ()),
            ("bond_conv[pair]", ops.fused_bond_conv, ref.fused_bond_conv_ref,
             (f(atoms, d), f(rows, d), f(n_edges, d), f(eu, d))
             + mlp(4 * d, d) + bond, {"pair": pair_b}, (pair_b,)))
        for name, wrapper, plain, args, kw, extra in cases:
            for dtype, bargs, check in (
                    ("f32", args, _check_close),
                    ("bf16", _to_bf16(args), _check_round_bf16)):
                got = wrapper(*bargs, **kw)
                if not torch.equal(got, wrapper(*bargs, **kw)):
                    raise RuntimeError(f"{name} {dtype} on {label}: two "
                                       "calls on the same inputs differ")
                check(f"{name} {dtype} on {label}", got,
                      plain(*bargs, *extra))
                n += 1
    return n


def readout_edge_cases(f, seed: int) -> int:
    """The split-f32 force readouts (kernels 4a and 4b) against their plain
    versions at every width of ``ops.CONV_WIDTHS`` on layouts at the edges
    of their partition, tiles and crystal sum: one atom row of 700 bonds,
    rows straddling tiles, a crystal with no bonds between two that have
    them (and an empty crystal slot), every row padded; crystals owning
    contiguous atom ranges in slot order, as the packer lays them out,
    then in a permuted slot order with an empty slot between, and
    crystals whose rows interleave (a row's bonds always in its atom's
    crystal).  Each runs twice: the two calls must give equal bits.  Both
    also run with their operands rounded to bf16 (kernels 4a's and 4b's
    bf16 paths, 4b's distances f32: the bf16 forces within one bf16
    rounding of the plain version, 4b's f32 sums at the same bound).
    Returns the number of cases checked."""
    rng = np.random.default_rng(seed + 3)
    layouts = (  # bonds per atom row, crystal of each row, padded bonds
        ("one row of 700 bonds", [700, 3, 0, 5], [0, 0, 1, 1], 20),
        ("rows straddling tiles", rng.integers(0, 300, 12).tolist(),
         [0] * 5 + [1] * 7, 5),
        ("a crystal with no bonds between two",
         [40, 0, 90, 0, 0, 150, 7, 60], [0, 0, 0, 1, 1, 2, 2, 2], 9),
        ("every row padded", [0] * 6, [0, 0, 1, 1, 2, 2], 40),
        ("crystal slots permuted", rng.integers(0, 90, 40).tolist(),
         [3] * 12 + [0] * 9 + [2] * 19, 11),
        ("crystals interleaved", rng.integers(0, 90, 40).tolist(),
         rng.integers(0, 4, 40).tolist(), 7))
    n = 0
    for label, lens, row_cry, tail in layouts:
        rows, n_real, n_crys = len(lens), sum(lens), 4
        seg = np.zeros(n_real + tail, np.int32)
        seg[:n_real] = np.repeat(np.arange(rows), lens)
        cry = np.zeros(n_real + tail, np.int32)
        cry[:n_real] = np.asarray(row_cry, np.int32)[seg[:n_real]]
        offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        seg, cry, offs = (torch.from_numpy(x).cuda()
                          for x in (seg, cry, offs))
        for d in ops.CONV_WIDTHS:
            xh = f(n_real + tail, 3)
            fargs = (f(n_real + tail, d), xh / xh.norm(dim=1, keepdim=True),
                     f(d, d, scale=d ** -0.5), f(d, scale=0.1),
                     f(d, 1, scale=d ** -0.5), f(1, scale=0.1), seg, offs,
                     rows)
            vargs = fargs[:2] + (f(n_real + tail).abs() + 0.5,) \
                + fargs[2:7] + (cry, offs, rows, n_crys)
            for name, wrapper, plain, args, check in (
                    ("force_readout", ops.fused_force_readout,
                     ref.fused_force_readout_ref, fargs, _check_close),
                    ("force_readout bf16", ops.fused_force_readout,
                     ref.fused_force_readout_ref, _to_bf16(fargs),
                     _check_round_bf16),
                    ("force_virial", ops.fused_force_virial_readout,
                     ref.fused_force_virial_readout_ref, vargs,
                     _check_close),
                    # kernel 4b's bf16 path, the distances f32 as the
                    # mixed path gives them
                    ("force_virial bf16", ops.fused_force_virial_readout,
                     ref.fused_force_virial_readout_ref,
                     _to_bf16(vargs[:2]) + vargs[2:3] + _to_bf16(vargs[3:]),
                     _check_bf16_path)):
                got = wrapper(*args)
                if not _equal(got, wrapper(*args)):
                    raise RuntimeError(f"{name} on {label}, D = {d}: two "
                                       "calls on the same inputs differ")
                check(f"{name} on {label}, D = {d}", got, plain(*args))
                n += 1
    return n


def tier_edge_cases(f, ids, csr) -> int:
    """The unfused tier's kernels against their plain versions on ragged
    and edge inputs: the segment sum at D = 3, 8 and 64 with empty rows,
    every edge padded and S of 1, 7 and 1000, and once from a view that is
    not 16-byte aligned (the scalar path at D = 64); the GatedMLP at M = 1,
    255 and 257, an input width that is no multiple of 4, d_in 0, 7, 300
    and 1,000 (several and partial K chunks) at D 8, 32 and 128, and from
    unaligned views (its 4-byte copies); both in f32 and on their bf16
    paths (twice: equal bits; within one bf16 rounding); the RBF at
    r = 0, 1e-9, r_cut and beyond; the Fourier basis at 0 and pi; then
    both bases at the edges of their tiles (``basis_edge_cases``)."""
    n = 0

    def both(label, wrapper, plain, args, bf16_args):
        """f32, then the bf16 path (called twice: equal bits) within one
        bf16 rounding of its plain version."""
        _check_close(f"{label} f32", wrapper(*args), plain(*args))
        got = wrapper(*bf16_args)
        if not torch.equal(got, wrapper(*bf16_args)):
            raise RuntimeError(f"{label} bf16: two calls on the same inputs "
                               "differ")
        _check_round_bf16(f"{label} bf16", got, plain(*bf16_args))
        return 2

    bf = torch.bfloat16
    for d in (3, 8, 64):
        for rows, n_edges, n_real in ((1, 10, 10), (7, 40, 0), (7, 50, 31),
                                      (1000, 3000, 2500)):
            seg, offs = csr(rows, n_edges, n_real)
            args = (f(n_edges, d), seg, offs, rows)
            n += both(f"segment_sum case {n}, D = {d}",
                      ops.fused_segment_sum, ref.sorted_segment_sum_ref,
                      args, _to_bf16(args))
    seg, offs = csr(37, 300, 260)
    # views that are not 16-byte aligned: the scalar paths at D = 64
    unaligned = f(300 * 64 + 1)[1:].view(300, 64)
    unaligned_bf = torch.zeros(300 * 64 + 1, dtype=bf, device="cuda")[1:] \
        .view(300, 64).copy_(unaligned)
    n += both(f"segment_sum case {n}, unaligned", ops.fused_segment_sum,
              ref.sorted_segment_sum_ref, (unaligned, seg, offs, 37),
              (unaligned_bf, seg, offs, 37))
    for m, d_in, d in ((1, 192, 64), (255, 256, 64), (257, 192, 64),
                       (33, 13, 16), (300, 300, 128), (40, 7, 8),
                       (513, 1000, 32), (20, 0, 64)):
        args = (f(m, d_in), f(d_in, 2 * d, scale=0.1), f(2 * d),
                f(2 * d).abs() + 0.5, f(2 * d))
        # bf16: x, w and b; the LayerNorm parameters f32, as on the path
        n += both(f"gated_mlp case {n}", ops.fused_gated_mlp_packed,
                  ref.fused_gated_mlp_ref, args,
                  _to_bf16(args[:3]) + args[3:])
    # x and W from views that are not 16-byte aligned (f32: 4-byte copies;
    # bf16: 2-byte loads)
    args = (f(100 * 192 + 1)[1:].view(100, 192),
            f(192 * 128 + 1, scale=0.1)[1:].view(192, 128), f(128),
            f(128).abs() + 0.5, f(128))
    bf_args = tuple(torch.zeros(t.numel() + 1, dtype=bf, device="cuda")[1:]
                    .view(t.shape).copy_(t) for t in args[:2]) \
        + (args[2].to(bf),) + args[3:]
    n += both(f"gated_mlp case {n}, unaligned", ops.fused_gated_mlp_packed,
              ref.fused_gated_mlp_ref, args, bf_args)
    r_cut = 6.0
    # rows 5-8: the padded bonds' 1e-8 and phases f_k xi either side of
    # 2^-12, where the kernel takes sin(x) = x
    dist = torch.cat([torch.tensor([0.0, 1e-9, r_cut, r_cut + 0.5, 1.0, 1e-8,
                                    1e-6, 1.4e-5, 1.6e-5], device="cuda"),
                      f(400).abs() * 2.0])
    freqs = torch.arange(1, 32, dtype=torch.float32, device="cuda") * math.pi
    freqs = freqs + f(31, scale=0.05)
    got = ops.fused_rbf(dist, freqs, r_cut, 8)
    want = ref.fused_rbf_ref(dist, freqs, r_cut, 8)
    _check_close(f"rbf case {n}", got, want)
    if got[0].any():
        raise RuntimeError("rbf: a padded bond (r = 0) must give exactly 0")
    tiny = (got[5:9] - want[5:9]).abs() / want[5:9].abs()
    if not (tiny <= 5e-7).all():
        raise RuntimeError(f"rbf: rows of tiny phases {tiny.max().item()} "
                           "from the plain version, relative (4 ulp: 5e-7)")
    n += 1
    for k in (7, 31, 127):
        theta = torch.cat([torch.tensor([0.0, math.pi], device="cuda"),
                           f(300).abs().clamp(max=math.pi)])
        _check_close(f"fourier case {n}", ops.fused_fourier(theta, k),
                     ref.fused_fourier_ref(theta, k))
        n += 1
    return n + basis_edge_cases(f)


def basis_edge_cases(f) -> int:
    """The RBF and Fourier kernels against their plain versions at K of 7,
    31 and 127 on row counts at the edges of their tiles (T of
    ``ops.basis_plan``): 0, 1, 3, T - 1, T + 1 and 4 T + 3 rows, with zero
    rows in the middle (padded bonds or angles amid real ones) and at the
    end.  Each runs twice: the two calls must give equal bits; an RBF row
    at r = 0 must be exactly 0.  Returns the number of cases checked."""
    n = 0
    r_cut = 6.0
    for kind in ("rbf", "fourier"):
        for k in (7, 31, 127):
            tile = ops.basis_plan(kind, 1, k, 132).tile
            for rows in (0, 1, 3, tile - 1, tile + 1, 4 * tile + 3):
                x = (f(rows).abs() * 2.0 if kind == "rbf"
                     else f(rows).abs().clamp(max=math.pi))
                zero = torch.zeros(rows, dtype=torch.bool, device="cuda")
                if rows >= 3:
                    zero[rows // 2:rows // 2 + rows // 8 + 1] = True
                    zero[-1] = True
                x = torch.where(zero, 0.0, x)
                if kind == "rbf":
                    freqs = torch.arange(1, k + 1, dtype=torch.float32,
                                         device="cuda") * math.pi \
                        + f(k, scale=0.05)
                    args = (x, freqs, r_cut, 8)
                    wrapper, plain = ops.fused_rbf, ref.fused_rbf_ref
                else:
                    args = (x, k)
                    wrapper, plain = ops.fused_fourier, ref.fused_fourier_ref
                label = f"{kind}_fwd, K = {k}, {rows} rows"
                got = wrapper(*args)
                if not torch.equal(got, wrapper(*args)):
                    raise RuntimeError(f"{label}: two calls on the same "
                                       "inputs differ")
                _check_close(label, got, plain(*args))
                if kind == "rbf" and got[zero].any():
                    raise RuntimeError(f"{label}: a padded bond (r = 0) "
                                       "must give exactly 0")
                n += 1
    return n


def serve_breakdown(md, serve) -> dict:
    """One more MD step's serving work taken apart on the host clock:
    neighbor lists, packing, and per group the copy to the card, the
    forward and the copy of the outputs back (which waits for it)."""
    clock = time.perf_counter
    t0 = clock()
    graphs = [r.nlist.update(r.crystal) for r in md.replicas]
    t_nlist = clock() - t0
    t_pack = t_fwd = 0.0
    for bucket, ids in md.groups(graphs):
        slots = _slots(len(ids))
        t0 = clock()
        batch, _ = serve.engine.pack(
            [md.replicas[i].crystal for i in ids], [graphs[i] for i in ids],
            caps=bucket.scaled(slots), num_crystal_slots=slots)
        t_pack += clock() - t0
        t0 = clock()
        out = serve.step_fn(bucket, slots)(batch)
        out["forces"].cpu()
        out["energy"].cpu()
        t_fwd += clock() - t0
    return {"nlist_update_ms": t_nlist * 1e3, "pack_ms": t_pack * 1e3,
            "h2d_forward_d2h_ms": t_fwd * 1e3}


def profile_step(step, out_file: Path | None, kernels=(),
                 aten_ops=()) -> dict:
    """Trace one call of ``step`` (an MD step, a training step) with
    torch.profiler: the device time summed over kernels and copies, the
    events that take most of it, for each name in ``kernels`` the launches
    and device time of the kernels whose names contain it and, for each
    name in ``aten_ops``, the calls and own device time (the kernels they
    launch) of the ``aten::`` operators whose names contain it.  The full
    table goes to ``out_file`` where one is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    # device-side events only (kernels, copies): the aten:: rows repeat
    # the device time of the kernels they launch, and the profiler mirrors
    # each span of the program (``runtime.trace``) on the device as an
    # annotation over the kernels it covers
    events = sorted((e for e in averages if e.device_type != DeviceType.CPU
                     and e.self_device_time_total > 0
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: -e.self_device_time_total)
    if out_file is not None:
        out_file.parent.mkdir(parents=True, exist_ok=True)
        out_file.write_text(averages.table(
            sort_by="self_device_time_total", row_limit=-1))
    named = {}
    for name in kernels:
        hits = [e for e in events if name in e.key]
        named[name] = {
            "count": sum(e.count for e in hits),
            "device_ms": sum(e.self_device_time_total for e in hits) / 1e3}
    for name in aten_ops:
        hits = [e for e in averages if e.device_type == DeviceType.CPU
                and name in e.key]
        named[name] = {
            "count": sum(e.count for e in hits),
            "device_ms": sum(e.self_device_time_total for e in hits) / 1e3}
    return {
        "device_ms": sum(e.self_device_time_total for e in events) / 1e3,
        "device_events": sum(e.count for e in events),
        "top": [{"name": e.key[:60], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3}
                for e in events[:12]],
        "kernels": named,
    }


def _epochs(ds, caps, batch: int, seed: int, log: list | None = None):
    """Endless single-device batches, one ``BatchIterator`` per epoch (the
    sampler's seed repeats the order, as tests/test_trainer_e2e.py does);
    with ``log``, appends (pack seconds, real crystals, real atoms,
    (atom, bond, angle) capacities) of each batch packed, in order."""
    while True:
        it = iter(BatchIterator(ds, batch, 1, caps, seed=seed))
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            if b is None:
                break
            if log is not None:
                log.append((time.perf_counter() - t0,
                            int(b.crystal_mask.sum()),
                            int(b.atom_mask.sum()),
                            (b.atom_cap, b.bond_cap, b.angle_cap)))
            yield b


def _check_grads_mixed(g_k, g_p) -> dict:
    """DESIGN.md §4's gradient bound over every leaf: the global norm of
    the difference within 5% of the plain path's, cosine at least 0.999
    (the two paths round to bf16 at other places); raises if not."""
    sq = lambda gs: sum((g.double() ** 2).sum() for g in gs)  # noqa: E731
    norm = sq(g_p).sqrt()
    rel = (sq([a.double() - b.double() for a, b in zip(g_k, g_p,
                                                       strict=True)]).sqrt()
           / norm).item()
    cos = (sum((a.double() * b.double()).sum() for a, b in zip(g_k, g_p))
           / (norm * sq(g_k).sqrt())).item()
    if not (rel < 0.05 and cos >= 0.999):
        raise RuntimeError(f"gradients: relative error {rel} (below 0.05), "
                           f"cosine {cos} (at least 0.999)")
    return {"grad_rel_err": rel, "grad_cosine": cos}


def plain_path_check(params, cfg, batch, reference=None) -> dict:
    """Loss and every gradient leaf of the kernels' path against the plain
    path (``plain_config``, at the same precision) on the card; also the
    launches of the kernels' forward (its backward launches none).  In f32
    each within ``1e-4 * max(1, max|plain|)``; at a bf16 compute dtype
    (the mixed tiers) DESIGN.md §4's bounds: the loss within ``3e-2 *
    max(1, |plain|)``, the gradients within 5% relative global norm and
    cosine 0.999, every launch through a bf16 entry; with ``reference``
    (its f32 config, on the kernels' path) against that config at the
    same bounds."""
    ops.reset_launch_counts()
    loss_k, _ = chgnet_loss_fn(params, cfg, batch, chgnet_mptrj.LOSS)
    g_k = grads_of(loss_k, params)
    launched = ops.launch_counts()
    entries = ops.entry_launch_counts()
    if not any(launched.values()):
        raise RuntimeError("the kernels' path launched no kernel")
    loss_p, _ = chgnet_loss_fn(params, plain_config(cfg), batch,
                               chgnet_mptrj.LOSS)
    g_p = grads_of(loss_p, params)
    torch.cuda.synchronize()
    if resolve_policy(cfg.precision).low_precision_compute:
        check_bf16_entries("plain-path check", entries, launched)
        err_l, tol_l, _ = _check_bf16("train loss", loss_k.detach(),
                                      loss_p.detach())
        row = {"loss": loss_p.item(), "loss_max_abs_err": err_l,
               "loss_tolerance": tol_l, "grad_leaves": len(g_k),
               **_check_grads_mixed(g_k, g_p), "launches": launched,
               "entries": entries}
        if reference is not None:
            loss_r, _ = chgnet_loss_fn(params, reference, batch,
                                       chgnet_mptrj.LOSS)
            g_r = grads_of(loss_r, params)
            err_r, tol_r, _ = _check_bf16("train loss against f32",
                                          loss_k.detach(), loss_r.detach())
            row["f32_config"] = {"loss": loss_r.item(),
                                 "loss_max_abs_err": err_r,
                                 "loss_tolerance": tol_r,
                                 **_check_grads_mixed(g_k, g_r)}
        return row
    err_l, tol_l = _check_close("train loss", loss_k.detach(),
                                loss_p.detach())
    errs = [_check_close(f"grad leaf {i}", a, b)
            for i, (a, b) in enumerate(zip(g_k, g_p, strict=True))]
    return {"loss": loss_p.item(), "loss_max_abs_err": err_l,
            "loss_tolerance": tol_l, "grad_leaves": len(errs),
            "grad_max_abs_err": max(e for e, _ in errs),
            "grad_worst_err_over_tolerance": max(e / t for e, t in errs),
            "launches": launched}


def fused_mlp_pallas_phase(seed: int, batch) -> dict:
    """``FAST_FUSED`` with ``mlp_impl="pallas"``: one forward and backward
    on the first training batch against the plain path; the fused convs
    and readout beside the GatedMLP (angle updates) and basis kernels."""
    params = params_on(chgnet.chgnet_init(seed, FUSED_MLP_PALLAS), "cuda")
    row = plain_path_check(params, FUSED_MLP_PALLAS, batch)
    check_launches("FUSED_MLP_PALLAS", row["launches"], PER_FORWARD_FUSED_MLP,
                   1)
    print(f"FUSED_MLP_PALLAS: launches {row['launches']}; plain path {row}",
          flush=True)
    return row


def half_equals_fused_phase(seed: int, batch) -> dict:
    """``FAST_FUSED_HALF`` computes ``FAST_FUSED``'s function (DESIGN.md
    §5): one parameter tree, one batch, every output and the loss within
    the bound, each path launching its kernels."""
    params = params_on(chgnet.chgnet_init(seed, chgnet_mptrj.FAST_FUSED),
                       "cuda")
    outs, losses = {}, {}
    with torch.inference_mode():
        for name, cfg in (("FAST_FUSED_HALF", chgnet_mptrj.FAST_FUSED_HALF),
                          ("FAST_FUSED", chgnet_mptrj.FAST_FUSED)):
            ops.reset_launch_counts()
            outs[name] = chgnet.chgnet_apply(params, cfg, batch)
            check_launches(f"{name} same-function check", ops.launch_counts(),
                           PER_FORWARD, 1)
            losses[name] = chgnet_loss_fn(params, cfg, batch,
                                          chgnet_mptrj.LOSS)[0]
    torch.cuda.synchronize()
    errs = {k: _check_close(f"FAST_FUSED_HALF {k}", outs["FAST_FUSED_HALF"][k],
                            outs["FAST_FUSED"][k])
            for k in ("energy", "forces", "stress", "magmom")}
    errs["loss"] = _check_close("FAST_FUSED_HALF loss",
                                losses["FAST_FUSED_HALF"],
                                losses["FAST_FUSED"])
    row = {k: {"max_abs_err": e, "tolerance": t} for k, (e, t) in errs.items()}
    print(f"FAST_FUSED_HALF against FAST_FUSED: {row}", flush=True)
    return row


def step_split(tr, batches, n: int) -> dict:
    """``n`` more steps taken apart: packing and the host-to-device copy on
    the host clock, then forward (model + loss), backward and optimizer
    (clip + Adam; at a mixed tier also the unscale, the finite check and
    its read) on CUDA events.  Means in ms."""
    from repro_torch.optim.schedule import cosine_annealing

    tcfg = tr.train_cfg
    parts = {"pack_ms": 0.0, "h2d_ms": 0.0, "forward_ms": 0.0,
             "backward_ms": 0.0, "optimizer_ms": 0.0, "step_ms": 0.0}
    clock = time.perf_counter
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = clock()
        b = next(batches)
        t1 = clock()
        b = b.to(tr.device)
        torch.cuda.synchronize()
        t2 = clock()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, metrics = chgnet_loss_fn(tr.params, tr.model_cfg, b,
                                       tcfg.loss)
        scaler = tr.opt_state.get("loss_scale")
        ev[1].record()
        grads = grads_of(loss if scaler is None
                         else scale_loss(loss, scaler), tr.params)
        ev[2].record()
        lr = cosine_annealing(tr.step, tcfg.total_steps, tcfg.init_lr,
                              warmup_steps=tcfg.warmup_steps)
        tr.params, tr.opt_state, _ = apply_grads(
            grads, tr.opt_state, tr.params, lr, tcfg,
            tcfg.loss_scale.resolved_kind(tr.model_cfg.precision), metrics)
        ev[3].record()
        torch.cuda.synchronize()
        tr.step += 1
        for k, v in (("pack_ms", t1 - t0), ("h2d_ms", t2 - t1),
                     ("step_ms", clock() - t0)):
            parts[k] += v * 1e3 / n
        for k, i in (("forward_ms", 0), ("backward_ms", 1),
                     ("optimizer_ms", 2)):
            parts[k] += ev[i].elapsed_time(ev[i + 1]) / n
    return parts


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms (the per-crystal ``index_add_``
    sums of the heads otherwise add with atomics, in no fixed order), with
    warnings only where an operator has none."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def _bucket(caps, shape) -> int | None:
    """The index of the ladder bucket of (atom, bond, angle) capacities
    ``shape`` (-1 for an overflow bucket), None for fixed capacities."""
    if not isinstance(caps, CapacityLadder):
        return None
    keys = [(b.atoms, b.bonds, b.angles) for b in caps.buckets]
    return keys.index(shape) if shape in keys else -1


def prefetch_checks(tr, cfg, tcfg, first, batches, seed: int) -> dict:
    """The first batch through ``Prefetcher(device="cuda")`` against the
    synchronous ``.to("cuda")`` batch, field for field and bit for bit;
    then the warm-up step on it, whose loss must equal bit for bit that of
    the same step of a second ``Trainer`` fed the synchronous batch (both
    under deterministic algorithms)."""
    got = next(batches)
    differ = [k for k in FIELDS if not torch.equal(getattr(got, k),
                                                   getattr(first, k))]
    if differ:
        raise RuntimeError(f"prefetched first batch differs in {differ}")
    with _deterministic():
        loss = tr.train([got])[0]["loss"]
        twin = Trainer(cfg, tcfg, seed=seed, device="cuda")
        loss_sync = twin.train([first])[0]["loss"]
    if loss != loss_sync:
        raise RuntimeError(f"first step's loss {loss!r} through the "
                           f"prefetcher, {loss_sync!r} fed synchronously")
    del twin
    return {"first_batch_bitwise_equal": True, "first_loss": loss,
            "first_loss_sync": loss_sync}


def train_phase(name: str, cfg, ds, caps, steps: int, per_forward: dict,
                seed: int, profile: str | None, traced=(), aten_ops=(),
                prefetch: bool = False, reference=None) -> dict:
    """``Trainer`` at ``cfg`` over batches of ``TRAIN_BATCH`` crystals, at
    fixed capacities or on a ``CapacityLadder`` (each batch in the smallest
    bucket that fits; the bucket of each counted step is reported): on a
    kernels' path the plain-path check on the first batch; then 1 warm-up
    step, ``steps`` counted steps of the main path, two steps taken apart
    and, with ``profile`` or names in ``traced`` (kernels, each of which
    must show) or ``aten_ops`` (operators), one traced step.
    ``per_forward`` empty means a path without kernels (``REFERENCE``),
    which must launch none.  With ``prefetch`` the batches come through
    ``Prefetcher(device="cuda")`` (``prefetch_checks`` on the first), and
    the packing thread's time and the steps' wait for it are reported:
    the share of packing the thread hides is 1 - wait / (pack + copy).  At
    a bf16 compute dtype every launch must go through a bf16 entry, and
    with ``reference`` (an f32 config of the same function) the first
    batch is also held to it (``plain_path_check``)."""
    tcfg = TrainConfig(global_batch=TRAIN_BATCH, total_steps=100,
                       loss=chgnet_mptrj.LOSS)
    tr = Trainer(cfg, tcfg, seed=seed, device="cuda")
    log, consumed = [], [0]

    def counted(it):  # log[i] is the i-th batch consumed
        for b in it:
            consumed[0] += 1
            yield b

    source = _epochs(ds, caps, TRAIN_BATCH, seed, log)
    first = plain = checks = pf = None
    if per_forward or prefetch:
        first = next(iter(BatchIterator(ds, TRAIN_BATCH, 1, caps,
                                        seed=seed))).to("cuda")
    if per_forward:
        plain = plain_path_check(tr.params, cfg, first, reference)
        check_launches(f"{name} plain-path check", plain["launches"],
                       per_forward, 1)
    try:
        if prefetch:
            pf = Prefetcher(source, depth=2, device="cuda")
            batches = counted(iter(pf))
            checks = prefetch_checks(tr, cfg, tcfg, first, batches, seed)
        else:
            batches = counted(source)
            tr.train(itertools.islice(batches, 1))
        del first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = consumed[0]
        stats0 = dict(pf.stats) if pf else None
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        hist = tr.train(itertools.islice(batches, steps))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = ops.launch_counts()
        bwd_counts = bwd_launch_counts()
        entries = ops.entry_launch_counts()
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()
        stats = ({k: pf.stats[k] - stats0[k] for k in stats0} if pf
                 else None)
        check_launches(name, counts, per_forward, steps)
        check_bwd_launches(name, bwd_counts, per_forward, steps)
        if per_forward and resolve_policy(cfg.precision) \
                .low_precision_compute:
            check_bf16_entries(name, entries, counts)
        for h in hist:
            if not (math.isfinite(h["loss"])
                    and math.isfinite(h["grad_norm"])):
                raise RuntimeError(f"{name}: non-finite loss or grad norm "
                                   f"{h}")
        steps_log = log[c0:c0 + steps]
        crystals = sum(e[1] for e in steps_log)
        atoms = sum(e[2] for e in steps_log)
        row = {
            "config": name, "batch": TRAIN_BATCH, "steps": steps,
            "ms_per_step": elapsed / steps * 1e3,
            "pack_ms_per_step": sum(e[0] for e in steps_log) / steps * 1e3,
            "crystals_per_s": crystals / elapsed,
            "atoms_per_s": atoms / elapsed,
            "peak_mem_bytes": peak, "peak_reserved_bytes": peak_reserved,
            "launches": counts, "bwd_launches": bwd_counts,
            "entries": entries, "caps_per_step": [e[3] for e in steps_log],
            "bucket_per_step": [_bucket(caps, e[3]) for e in steps_log],
            "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            # the mixed tiers' loss scaler (DESIGN.md §4)
            "loss_scales": [h.get("loss_scale") for h in hist],
            "grads_finite": [h.get("grads_finite") for h in hist],
            "plain_path": plain, "split": step_split(tr, batches, 2),
        }
        if pf:
            # packing on the worker over the counted steps (the log's times
            # are those of each batch's making, which ran ahead of them)
            row["pack_ms_per_step"] = stats["source_s"] / steps * 1e3
            work = stats["source_s"] + stats["copy_s"]
            row["prefetch"] = dict(
                checks, depth=2,
                pack_ms_per_step=stats["source_s"] / steps * 1e3,
                copy_ms_per_step=stats["copy_s"] / steps * 1e3,
                wait_ms_per_step=stats["wait_s"] / steps * 1e3,
                hidden_share=1 - stats["wait_s"] / work if work else None)
        if profile or traced or aten_ops:
            prof = row["profile"] = profile_step(
                lambda: tr.train(itertools.islice(batches, 1)),
                Path(profile) / f"train_step_profile_{name}.txt" if profile
                else None, traced, aten_ops)
            prof["busy_share"] = prof["device_ms"] / row["ms_per_step"]
            for kernel, t in prof["kernels"].items():
                if kernel in traced and not t["count"]:
                    raise RuntimeError(f"{name}: no {kernel} in the traced "
                                       "step")
                print(f"traced {name} step: {kernel} {t['count']} launches, "
                      f"{t['device_ms'] * 1e3:.2f} us on the card",
                      flush=True)
            print(f"traced {name} step: {prof['device_ms']:.2f} device ms "
                  f"in {prof['device_events']} events, busy share "
                  f"{prof['busy_share']:.2f}", flush=True)
    finally:
        if pf:
            pf.close()
    print(f"train {name}: {row['ms_per_step']:.2f} ms per step "
          f"({row['pack_ms_per_step']:.2f} ms of it packing), "
          f"{row['crystals_per_s']:.1f} crystals/s, {row['atoms_per_s']:.0f} "
          f"atoms/s, peak {peak / 2**20:.1f} MiB (reserved "
          f"{peak_reserved / 2**20:.1f}), buckets {row['bucket_per_step']}, "
          f"launches {counts}, losses {row['losses']}, loss scales "
          f"{row['loss_scales']}, grads finite {row['grads_finite']}; "
          f"plain path {plain}; "
          f"prefetch {row.get('prefetch')}; split {row['split']}",
          flush=True)
    del tr
    torch.cuda.empty_cache()
    return row


def serve_phase(name: str, cfg, params, crystals, probe, steps: int,
                per_forward: dict, profile: str | None = None,
                reference=None) -> dict:
    """``ServeEngine`` / ``BatchedMD`` at ``cfg`` over the replicas: one
    warm-up MD step, then ``steps`` counted steps of the main path (launch
    counts, finite outputs); the largest group's batch (``probe``) against
    the plain path (at a bf16 compute dtype within DESIGN.md §4's bound,
    ``_check_bf16``, every launch through a bf16 entry) and, with
    ``reference`` (an f32 config of the same function), against that
    config's outputs at the same bound; one
    forward per group timed on both paths; one step taken apart on the
    host clock and, with ``profile``, one traced."""
    autodiff = cfg.readout == "autodiff"
    # the autodiff readout differentiates: no inference tensors
    mode = torch.no_grad if autodiff else torch.inference_mode
    serve = ServeEngine.for_structures(params, cfg, crystals, device="cuda")
    md = BatchedMD(serve, crystals)
    md.step(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    packed0 = serve.engine.batches_packed
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = md.step(steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = ops.launch_counts()
    entries = ops.entry_launch_counts()
    forwards = serve.engine.batches_packed - packed0
    check_launches(f"serve {name}", counts, per_forward, forwards)
    if resolve_policy(cfg.precision).low_precision_compute:
        check_bf16_entries(f"serve {name}", entries, counts)
    if not (np.isfinite(out["energy"]).all()
            and all(np.isfinite(f).all() for f in out["forces"])):
        raise RuntimeError(f"serve {name}: outputs are not finite")
    peak = torch.cuda.max_memory_allocated()

    # the kernels' path against the plain path on the card
    sizes = [int(b.bond_offsets[-1]) for b in probe]
    big = probe[sizes.index(max(sizes))]
    tree = serve.model.tree()
    plain_cfg = plain_config(cfg)
    keys = ("energy", "forces", "stress") if autodiff \
        else ("energy", "forces")
    check = (_check_bf16 if resolve_policy(cfg.precision)
             .low_precision_compute else _check_close)
    ops.reset_launch_counts()
    with mode():
        got = serve.model(big)
        check_launches(f"serve {name} plain-path check",
                       ops.launch_counts(), per_forward, 1)
        want = chgnet.chgnet_apply(tree, plain_cfg, big)
        want_ref = None if reference is None \
            else chgnet.chgnet_apply(tree, reference, big)
    errs = {k: check(f"serve {name} {k}", got[k], want[k])[:2]
            for k in keys}
    ref_errs = {} if want_ref is None else {
        k: _check_bf16(f"serve {name} {k} against f32", got[k],
                       want_ref[k]) for k in keys}

    forward_ms, plain_forward_ms = [], []
    with mode():
        for b in probe:
            forward_ms.append(_time_ms(lambda: serve.model(b), 10, 3))
            plain_forward_ms.append(_time_ms(
                lambda: chgnet.chgnet_apply(tree, plain_cfg, b), 10, 3))
    breakdown = serve_breakdown(md, serve)
    if profile:
        prof = breakdown["profile"] = profile_step(
            lambda: md.step(1),
            Path(profile) / f"serve_step_profile_{name}.txt")
        # device time of one traced step over the untraced step's wall time
        prof["busy_share"] = prof["device_ms"] / (elapsed / steps * 1e3)
    row = {
        "config": name, "replicas": len(crystals), "steps": steps,
        "forwards": forwards, "groups_per_step": forwards / steps,
        "ms_per_batched_step": elapsed / steps * 1e3,
        "replica_steps_per_s": len(crystals) * steps / elapsed,
        "peak_mem_bytes": peak, "launches": counts, "entries": entries,
        "plain_path_max_abs_err": {k: e for k, (e, _) in errs.items()},
        "plain_path_tolerance": {k: t for k, (_, t) in errs.items()},
        # the mixed tiers against the f32 config (DESIGN.md §4)
        "f32_max_abs_err": {k: e[0] for k, e in ref_errs.items()},
        "f32_tolerance": {k: e[1] for k, e in ref_errs.items()},
        "f32_cosine": {k: e[2] for k, e in ref_errs.items()},
        "forward_ms": forward_ms, "plain_forward_ms": plain_forward_ms,
        "breakdown": breakdown, "stats": md.stats(),
    }
    print(f"serve {name}: {row['ms_per_batched_step']:.2f} ms per batched "
          f"step, {row['replica_steps_per_s']:.1f} replica-steps/s, "
          f"peak {peak / 2**20:.1f} MiB, launches {counts}; forward per "
          f"group {forward_ms} ms (plain path {plain_forward_ms} ms); "
          f"plain-path errors {row['plain_path_max_abs_err']} (against "
          f"f32: {row['f32_max_abs_err']}, cosine {row['f32_cosine']}); "
          f"one step "
          f"{breakdown}", flush=True)
    return row


def learns_phase(seed: int, cfg=chgnet_mptrj.FAST_FUSED) -> dict:
    """tests/test_trainer_e2e.py::test_training_reduces_loss on the card at
    ``cfg`` (FAST_FUSED, FAST_FUSED_MIXED): 96 crystals of at most 20
    atoms, batch 8, lr_k=1 with 5 warm-up steps; after 60 steps a held-out
    batch's loss must be below 0.6x its value before."""
    ds = make_dataset(SyntheticConfig(num_crystals=96, max_atoms=20,
                                      seed=0))
    caps = capacity_for(ds, 8)
    tcfg = TrainConfig(global_batch=8, total_steps=300, lr_k=1,
                       warmup_steps=5)
    tr = Trainer(cfg, tcfg, seed=seed, device="cuda")
    held_out = next(iter(BatchIterator(ds, 8, 1, caps, seed=99)))
    before = tr.evaluate(held_out)["loss"]
    t0 = time.perf_counter()
    hist = tr.train(itertools.islice(_epochs(ds, caps, 8, 0), 60))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    after = tr.evaluate(held_out)["loss"]
    skipped = sum(h.get("grads_finite", 1.0) == 0.0 for h in hist)
    print(f"learns {cfg.precision}: held-out loss {before:.4f} -> "
          f"{after:.4f} after 60 steps ({elapsed:.2f} s, {skipped} steps "
          "skipped by the loss scaler)", flush=True)
    if not after < 0.6 * before:
        raise RuntimeError(f"held-out loss {before} -> {after}: not below "
                           "0.6x after 60 steps")
    return {"precision": cfg.precision, "before": before, "after": after,
            "ratio": after / before, "steps": 60, "seconds": elapsed,
            "skipped_steps": skipped}


def _rand(gen, shape, dtype, scale=1.0):
    """Normal numbers from ``gen`` on the card, drawn in f32, in ``dtype``."""
    x = torch.randn(shape, generator=gen, device="cuda")
    return x.mul_(scale).to(dtype)


def _plan_row(plan) -> dict:
    return dict(plan._asdict(), gate_blocks=plan.gate_blocks,
                down_blocks=plan.down_blocks)


def ptxas_lines(log: str) -> list[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name
    (demangled where ``c++filt`` is installed), registers, stack, spills
    and static shared memory (the kernels' rings are dynamic: their size
    is the plan's)."""
    names, stats, cur = [], {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", line)
        if m:
            cur = m.group(1)
            if cur not in stats:
                names.append(cur)
                stats[cur] = []
            continue
        if cur and re.search(r"registers|spill|stack frame", line):
            stats[cur].append(line.split(":", 1)[-1].strip())
    try:
        demangled = subprocess.run(["c++filt"], input="\n".join(names),
                                   capture_output=True, text=True,
                                   check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        demangled = names
    short = [re.sub(r"^void |[(].*", "",
                    d.replace("(anonymous namespace)::", "")) for d in demangled]
    return [f"{d}: {'; '.join(stats[n])}" for n, d in zip(names, short)]


def swiglu_case(gen, name: str, m: int, weights, act: str, dtype,
                path: str | None = None, yardstick: bool = False) -> dict:
    """Kernel 10 on (M, D) inputs drawn from ``gen`` and the given (wg, wu,
    wd): its plain version, its work (6 M D F flops; x, the weights and the
    output moved once), its plan and, for a case on a model path
    (``path``) or with ``yardstick``, the plain LM path's MLP at the same
    shapes as its ``composition``."""
    wg, wu, wd = weights
    d, f = wg.shape
    x = _rand(gen, (m, d), dtype)
    size = x.element_size()
    bf16 = dtype == torch.bfloat16
    composition = None
    if path or yardstick:
        def composition(x=x, p={"wg": wg, "wu": wu, "wd": wd}, act=act):
            return layers.gated_mlp_apply(p, x, act, use_pallas=False)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(
        name=name, counter="fused_swiglu", path=path,
        wrapper=lambda *a, act=act: ops.fused_swiglu(*a, activation=act),
        plain=lambda *a, act=act: ref.fused_swiglu_ref(*a, act),
        args=(x, wg, wu, wd), source=f"{CSRC}/swiglu.cu",
        composition=composition,
        replaces=f"{LM_TPU_DIR}/fused_swiglu.py:49", split=not bf16,
        check=_check_bf16 if bf16 else _check_close,
        peak=PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS,
        flops=6 * m * d * f, bytes=size * (2 * m * d + 3 * d * f),
        plan=_plan_row(ops.swiglu_plan(m, d, f, size, sms)),
        shape={"M": m, "D": d, "F": f, "dtype": str(dtype)[6:],
               "activation": act})


def lm_kernel_cases(mlp, gen) -> list[dict]:
    """Kernels 10 and 11, their plain versions and inputs.  The fused
    feed-forward on layer 0's weights at the serving path's shapes
    (prefill M = 4 x 512, decode M = 4; D 4096, F 14336, bf16), each beside
    the plain LM path's MLP at the same shapes (``composition``: three
    cuBLAS products and the activation); in f32 at full width; at the
    edges of its schedule (M = 1 and 16: the narrow decode plan and its
    split-K sum; M = 64 / 65: the last narrow and first wide plan; M = 129:
    a ragged wide row tile; M = 2,341: ragged M at prefill scale) and at
    ragged D and F (TMA and the element-wise producer; f32 aligned and
    not); flash attention at (B 4, H 32, S 512, D 128), causal and not,
    bf16 and f32, beside ``scaled_dot_product_attention`` (a yardstick the
    port never calls), and at ragged S, Sq < Sk (the top-left causal
    convention) and D 64 / 256 in both dtypes.  Work: the feed-forward's 6
    M D F flops and its operands read and output written once;
    attention's 4 D flops per unmasked (q, k) pair (q k and p v), q, k, v
    read and out written once.  Peak rate by the operand type: bf16 on the
    tensor cores; f32, for both kernels' split f32, three TF32 products
    per product (``kernel_phase``), the f32 FMA bound beside it.  The f32
    feed-forward also at full width at M 4, 16 and 256, each beside the
    plain path's cuBLAS f32 MLP."""
    cases = []
    src11 = f"{CSRC}/flash_attention.cu"

    def swiglu(*a, **kw):
        cases.append(swiglu_case(gen, *a, **kw))

    def small(d, f, dtype):
        return (_rand(gen, (d, f), dtype, d ** -0.5),
                _rand(gen, (d, f), dtype, d ** -0.5),
                _rand(gen, (f, d), dtype, f ** -0.5))

    full = (mlp["wg"], mlp["wu"], mlp["wd"])
    swiglu("swiglu_fwd prefill", LM_BATCH * LM_PROMPT, full, "silu",
           torch.bfloat16, "prefill")
    swiglu("swiglu_fwd decode", LM_BATCH, full, "silu", torch.bfloat16,
           "decode")
    # f32 in split f32 at full width, beside the plain path's cuBLAS f32
    # MLP: M 128, decode (4, 16) and the f32 check's prefill (2 x 128)
    full32 = tuple(w.float() for w in full)
    swiglu("swiglu_fwd f32", 128, full32, "silu", torch.float32,
           yardstick=True)
    for m in (4, 16, 256):
        swiglu(f"swiglu_fwd f32 M={m}", m, full32, "silu", torch.float32,
               yardstick=True)
    for m in (1, 16, 64, 65, 129, 2341):
        swiglu(f"swiglu_fwd M={m}", m, full, "silu", torch.bfloat16)
    swiglu("swiglu_fwd ragged", 37, small(512, 1000, torch.bfloat16),
           "gelu", torch.bfloat16)
    swiglu("swiglu_fwd ragged unaligned", 130,
           small(512, 1001, torch.bfloat16), "silu", torch.bfloat16)
    swiglu("swiglu_fwd ragged f32", 200, small(100, 160, torch.float32),
           "gelu", torch.float32)
    swiglu("swiglu_fwd ragged f32 unaligned", 65,
           small(99, 160, torch.float32), "silu", torch.float32)

    def flash(name, b, h, sq, sk, d, causal, dtype, library=False):
        q = _rand(gen, (b, h, sq, d), dtype)
        k = _rand(gen, (b, h, sk, d), dtype)
        v = _rand(gen, (b, h, sk, d), dtype)
        bf16 = dtype == torch.bfloat16
        pairs = sum(min(i + 1, sk) for i in range(sq)) if causal \
            else sq * sk
        lib = None
        if library:
            def lib(q=q, k=k, v=v, causal=causal):
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)
        cases.append(dict(
            name=name, counter="flash_attention",
            wrapper=lambda *a, c=causal: ops.flash_attention(*a, causal=c),
            plain=lambda *a, c=causal, d=d: ref.flash_attention_ref(
                *a, causal=c, scale=float(1.0 / d ** 0.5)),
            args=(q, k, v), library=lib, source=src11, split=not bf16,
            replaces=f"{LM_TPU_DIR}/flash_attention.py:74",
            check=_check_bf16 if bf16 else _check_close,
            peak=PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS,
            flops=4 * d * pairs * b * h,
            bytes=q.element_size() * b * h * d * (2 * sq + 2 * sk),
            shape={"B": b, "H": h, "Sq": sq, "Sk": sk, "D": d,
                   "causal": causal, "dtype": str(dtype)[6:]}))

    shape = (LM_BATCH, 32, LM_PROMPT, LM_PROMPT, 128)
    flash("flash_attention_fwd causal", *shape, True, torch.bfloat16, True)
    flash("flash_attention_fwd", *shape, False, torch.bfloat16, True)
    flash("flash_attention_fwd causal f32", *shape, True, torch.float32,
          True)
    flash("flash_attention_fwd f32", *shape, False, torch.float32, True)
    flash("flash_attention_fwd ragged", 2, 3, 300, 300, 64, True,
          torch.float32)
    flash("flash_attention_fwd ragged bf16", 2, 3, 300, 300, 64, True,
          torch.bfloat16)
    flash("flash_attention_fwd Sq<Sk", 2, 3, 100, 300, 128, True,
          torch.bfloat16)
    flash("flash_attention_fwd D=256", 1, 2, 77, 129, 256, False,
          torch.float32)
    flash("flash_attention_fwd D=256 causal f32", 1, 2, 200, 200, 256, True,
          torch.float32)
    flash("flash_attention_fwd Sq<Sk f32", 2, 3, 100, 300, 128, True,
          torch.float32)
    flash("flash_attention_fwd one query f32", 1, 2, 1, 5, 128, False,
          torch.float32)
    flash("flash_attention_fwd D=256 bf16", 1, 2, 77, 129, 256, True,
          torch.bfloat16)
    flash("flash_attention_fwd one query", 1, 2, 1, 5, 64, True,
          torch.bfloat16)
    return cases


def lm_f32_check(seed: int) -> dict:
    """The algorithm without bf16 noise: llama3-8b cut to 2 layers at full
    width in f32 (cache too), 2 prompts of 128 tokens and 4 decode steps,
    the kernels' path teacher-forced on the plain path's tokens; every
    logit within ``1e-4 * max(1, max|plain|)``."""
    cfg = lm_configs.get_config(LM_ARCH).with_(num_layers=2,
                                                compute_dtype="float32")
    params = transformer.decoder_init(cfg, seed, device="cuda")
    params = lm.load_serving_params(params, cfg, serve_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen,
                           device="cuda")
    plain, fed = family_forced_run(cfg, params, tokens,
                                   _text_positions(tokens), 4, 160, False,
                                   cache_dtype=torch.float32)
    ops.reset_launch_counts()
    got, _ = family_forced_run(cfg, params, tokens, _text_positions(tokens),
                               4, 160, True, forced=fed,
                               cache_dtype=torch.float32)
    counts = ops.launch_counts()
    check_launches("lm f32", counts, {"fused_swiglu": 2}, 5)
    errs = [_check_close(f"lm f32 step {i}", g, p)
            for i, (g, p) in enumerate(zip(got, plain))]
    row = {"layers": 2, "prompts": 2, "prompt_len": 128, "decode_steps": 4,
           "max_abs_err": max(e for e, _ in errs),
           "tolerance": min(t for _, t in errs),
           "launches": counts["fused_swiglu"]}
    print(f"lm f32 check ({LM_ARCH}, 2 layers, full width): logits of the "
          f"kernels' path within {row['max_abs_err']:.3e} of the plain "
          f"path's (tolerance {row['tolerance']:.3e})", flush=True)
    return row


def lm_forced_pair(name: str, cfg, params, tokens, steps: int) -> dict:
    """The kernels' path teacher-forced on the plain path's greedy tokens,
    every step's logits at DESIGN.md §4's bf16 bound."""
    pos_fn = _text_positions(tokens)
    plain, fed = family_forced_run(cfg, params, tokens, pos_fn, steps,
                                   LM_MAX_LEN, False)
    got, _ = family_forced_run(cfg, params, tokens, pos_fn, steps,
                               LM_MAX_LEN, True, forced=fed)
    errs = [_check_bf16(f"{name} {'prefill' if i == 0 else f'decode {i}'}",
                        g, p) for i, (g, p) in enumerate(zip(got, plain))]
    agree = [float((g.argmax(-1) == p.argmax(-1)).float().mean())
             for g, p in zip(got, plain)]
    print(f"{name} teacher-forced, kernels' path against plain: max abs "
          f"error {max(e[0] for e in errs):.3e} (smallest tolerance "
          f"{min(e[1] for e in errs):.3e}), smallest cosine "
          f"{min(e[2] for e in errs):.6f}; greedy tokens agree "
          f"{sum(agree) / len(agree):.3f} (prefill + {steps} steps)",
          flush=True)
    return {"max_abs_err": [e[0] for e in errs],
            "tolerance": [e[1] for e in errs],
            "cosine": [e[2] for e in errs], "token_agreement": agree}


def lm_phase(seed: int, profile: str | None = None) -> tuple[dict, list]:
    """llama3-8b served at full width and depth with bf16 weights from the
    seed: the kernels' path (every layer's MLP through kernel 10) against
    the plain path, teacher-forced on the plain path's greedy tokens, at
    DESIGN.md §4's bound; both paths timed through the serving entry
    points in turns (plain, kernels, kernels, plain); kernels 10 and 11
    against their plain versions; the f32 two-layer check.  Returns the
    phase's row and the kernel rows of the ``kernels`` line."""
    cfg = lm_configs.get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = lm.load_serving_params(
        transformer.decoder_init(cfg, seed, device="cuda",
                                 dtype=torch.bfloat16), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device="cuda")
    print(f"lm: {LM_ARCH}, {n_params} parameters in bf16 "
          f"({sum(t.numel() * t.element_size() for t in leaves(params)) / 2**30:.2f}"
          f" GiB), drawn in {init_s:.2f} s; {LM_BATCH} prompts of "
          f"{LM_PROMPT} tokens, cache of {LM_MAX_LEN} positions, "
          f"{LM_DECODE} decode steps", flush=True)

    forced = lm_forced_pair("lm", cfg, params, tokens, LM_DECODE)
    runs = family_serve("lm", cfg, params, tokens, _text_positions(tokens),
                        LM_MAX_LEN)
    traces = {}
    if profile:
        positions = torch.arange(LM_PROMPT, device="cuda").expand(
            LM_BATCH, LM_PROMPT)
        for name, use in (("kernels", True), ("plain", False)):
            def prefill(use=use):
                return lm.prefill_step(cfg, params, tokens, positions,
                                       LM_MAX_LEN, use_pallas=use)
            _, cache = prefill()
            tok = tokens[:, -1:]
            traces[name] = {
                "prefill": profile_step(
                    prefill, Path(profile) / f"lm_prefill_{name}.txt"),
                "decode_step": profile_step(
                    lambda use=use, cache=cache: lm.decode_step(
                        cfg, params, tok, cache,
                        torch.full_like(tok, LM_PROMPT), use_pallas=use),
                    Path(profile) / f"lm_decode_{name}.txt")}
            del cache
            # device time of a traced call over the untraced call's wall
            # time (the first timed run of the path)
            r = runs[name][0]
            for part, wall in (("prefill", r["ms_per_prefill"]),
                               ("decode_step", r["ms_per_decode_step"])):
                t = traces[name][part]
                t["busy_share"] = t["device_ms"] / wall
                print(f"lm {name} {part} traced: {t['device_ms']:.3f} ms "
                      f"of device time in {t['device_events']} events, "
                      f"busy share {t['busy_share']:.2f}; top "
                      f"{[(e['name'][:40], round(e['device_ms'], 3)) for e in t['top'][:4]]}",
                      flush=True)

    cases = lm_kernel_cases(
        transformer.layer_params(params["layers"], 0)["mlp"], gen)
    krows = kernel_phase(cases)
    kernel_run = runs["kernels"][0]
    for row, c in zip(krows, cases):
        # kernel 11 is on no model path (the JAX package's prefill runs jnp
        # attention), so its launch count on the main path is 0
        row["launches"] = {"prefill": kernel_run["prefill_launches"],
                           "decode": kernel_run["decode_launches"]
                           }.get(c.get("path"), 0)
        row["on_main_path"] = c["counter"] == "fused_swiglu"
    primary = [r for r in krows if r["name"] in (
        "swiglu_fwd prefill", "swiglu_fwd decode", "swiglu_fwd f32",
        "flash_attention_fwd causal", "flash_attention_fwd",
        "flash_attention_fwd causal f32", "flash_attention_fwd f32")]
    del params, cases
    torch.cuda.empty_cache()
    f32 = lm_f32_check(seed)
    # kernel 10's f32 path runs on the f32 check's path (2 layers, a
    # prefill and 4 decode steps)
    for row in krows:
        if row["wrapper"] == "fused_swiglu" and row["shape"]["dtype"] == \
                "float32":
            row["launches"] = f32["launches"]
    row = {
        "arch": LM_ARCH, "parameters": n_params, "dtype": "bfloat16",
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "max_len": LM_MAX_LEN,
        "decode_steps": LM_DECODE, "init_s": init_s,
        "teacher_forced": forced, "serve": runs, "f32_two_layers": f32,
        "kernel_extra_shapes": [r for r in krows if r not in primary]}
    if traces:
        row["profile"] = traces
    return row, primary


def eval_serve_phase(seed: int, batches: dict) -> dict:
    """``make_chgnet_eval_serve_step`` at ``FAST_FUSED`` and
    ``FAST_FUSED_SYM`` on each batch: under deterministic algorithms its
    metrics and outputs equal ``eval_step``'s and ``serve_step``'s bit for
    bit, its launches are one forward's; the combined step and the two
    steps timed in turns (CUDA events); and ``param_count`` beside the
    paper's Table I."""
    train_cfg = TrainConfig(global_batch=TRAIN_BATCH, loss=chgnet_mptrj.LOSS)
    rows = {}
    for name, per in (("FAST_FUSED", PER_FORWARD),
                      ("FAST_FUSED_SYM", PER_FORWARD_SYM)):
        cfg = getattr(chgnet_mptrj, name)
        params = params_on(chgnet.chgnet_init(seed, cfg), "cuda")
        step = make_chgnet_eval_serve_step(cfg, train_cfg)
        _, eval_step, serve_step = make_chgnet_step_fns(cfg, train_cfg)
        for bname, batch in batches.items():
            label = f"eval_serve {name} {bname}"
            with _deterministic():
                ops.reset_launch_counts()
                metrics, out = step(params, batch)
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                check_launches(label, counts, per, 1)
                want_m = eval_step(params, batch)
                want_o = serve_step(params, batch)
                for part, got, want in (("metric", metrics, want_m),
                                        ("output", out, want_o)):
                    if got.keys() != want.keys() or not all(
                            torch.equal(got[k], want[k]) for k in got):
                        raise RuntimeError(f"{label}: the {part}s differ "
                                           "from the separate steps'")
            es_ms, two_ms = _time_turns(
                [lambda: step(params, batch),
                 lambda: (eval_step(params, batch),
                          serve_step(params, batch))], reps=10, inner=3)
            rows[f"{name} {bname}"] = {
                "atoms": int(batch.atom_mask.sum()),
                "launches": {k: v for k, v in counts.items() if v},
                "bitwise_equal": True, "eval_serve_ms": es_ms,
                "eval_plus_serve_ms": two_ms,
                "loss": float(metrics["loss"])}
            print(f"{label}: {int(batch.atom_mask.sum())} atoms, one "
                  f"forward's launches {rows[f'{name} {bname}']['launches']}"
                  f", metrics and outputs equal the two steps' bit for bit; "
                  f"{es_ms:.3f} ms against {two_ms:.3f} ms for eval_step + "
                  "serve_step", flush=True)
        del params
    sizes = {name: chgnet.param_count(chgnet.chgnet_init(
        seed, getattr(chgnet_mptrj, name))) for name in
        ("FAST_FUSED", "REFERENCE")}
    paper = {"FAST_FUSED": 429_100, "REFERENCE": 412_500}
    for name, n in sizes.items():
        if abs(n - paper[name]) > 0.05 * paper[name]:
            raise RuntimeError(f"param_count {name}: {n}, not within 5% of "
                               f"the paper's {paper[name]}")
    print(f"param_count: FAST_FUSED {sizes['FAST_FUSED']} (paper 429.1K), "
          f"REFERENCE {sizes['REFERENCE']} (paper 412.5K)", flush=True)
    rows["param_count"] = sizes
    return rows


def _lm_batch(cfg, gen, b: int, s: int) -> tuple:
    """Seeded tokens (B, S) on the card, their next tokens as labels, and
    positions 0..S-1."""
    t = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                      device="cuda")
    return (t[:, :-1].contiguous(), t[:, 1:].contiguous(),
            torch.arange(s, device="cuda").expand(b, s))


def lm_train_run(name: str, cfg, params, batch, steps: int, **kw) -> dict:
    """1 + ``steps`` steps of ``make_lm_train_step`` on one repeated batch
    from ``params`` (updated in place): every loss finite, the last below
    the first; ms a counted step on the host clock (each step ends in a
    read of its loss), tokens/s, peak memory."""
    opt = adam_init(params)
    step = make_lm_train_step(cfg, **kw)
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(1 + steps):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, *batch)
        losses.append(loss.item())
        times.append(time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise RuntimeError(f"{name}: losses {losses} (finite, falling "
                           "expected)")
    ms = statistics.median(times[1:]) * 1e3
    tokens = batch[1].numel()  # the labels (whisper's batch[0] is frames)
    row = {"losses": losses, "ms_per_step": ms,
           "tokens_per_s": tokens / ms * 1e3,
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "accum_steps": kw.get("accum_steps", 1)}
    print(f"{name}: losses {[round(x, 4) for x in losses]}, "
          f"{ms:.1f} ms a step ({row['tokens_per_s']:.0f} tokens/s), peak "
          f"{row['peak_mib']:.0f} MiB", flush=True)
    del opt
    return row


def lm_train_phase(seed: int) -> dict:
    """llama3-8b at full width and 2 layers trained from the seed: f32
    master weights, bf16 compute.  The gradient at ``accum_steps`` 2
    against 1 on one batch (the loss within 3e-2, the global norm within
    5%, cosine 0.999: DESIGN.md §4); 1 + 5 steps on that batch; then the
    SMOKE config in f32, one step on the card against the same step on the
    CPU, every parameter within ``1e-4 * max(1, max|p|)`` and every
    leaf's update within 2% of lr element by element and 1% of the CPU's
    update in norm."""
    cfg = lm_configs.get_config(LM_ARCH).with_(num_layers=LM_TRAIN_LAYERS)
    params = transformer.decoder_init(cfg, seed, device="cuda")
    n_params = sum(t.numel() for t in leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    batch = _lm_batch(cfg, gen, LM_BATCH, LM_PROMPT)
    print(f"lm_train: {LM_ARCH} at full width, {LM_TRAIN_LAYERS} layers, "
          f"{n_params} f32 parameters ({n_params * 16 / 2**30:.2f} GiB with "
          f"gradients and Adam moments), bf16 compute, batch {LM_BATCH} x "
          f"{LM_PROMPT}", flush=True)
    l1, g1 = lm_grads(cfg, params, batch, 1)
    l2, g2 = lm_grads(cfg, params, batch, 2)
    n1, n2 = global_norm(g1).item(), global_norm(g2).item()
    dot = sum((a * b).sum(dtype=torch.float64).item()
              for a, b in zip(g1, g2))
    cos = dot / (n1 * n2)
    l1, l2 = l1.item(), l2.item()
    accum = {"loss_k1": l1, "loss_k2": l2, "grad_norm_k1": n1,
             "grad_norm_k2": n2, "cosine": cos}
    del g1, g2
    if not (abs(l2 - l1) <= 3e-2 * max(1.0, abs(l1))
            and abs(n2 - n1) <= 0.05 * n1 and cos >= 0.999):
        raise RuntimeError(f"lm_train accum 2 against 1: {accum}")
    print(f"lm_train accum 2 against 1: loss {l2:.6f} / {l1:.6f}, gradient "
          f"norm {n2:.6f} / {n1:.6f}, cosine {cos:.6f}", flush=True)
    row = {"arch": LM_ARCH, "layers": LM_TRAIN_LAYERS, "parameters": n_params,
           "batch": LM_BATCH, "seq": LM_PROMPT, "accum_2_vs_1": accum}
    row["k1"] = lm_train_run("lm_train k1", cfg, params, batch,
                             LM_TRAIN_STEPS)
    row["k2"] = lm_train_run("lm_train k2", cfg, params, batch, 2,
                             accum_steps=2)
    del params, batch
    torch.cuda.empty_cache()
    # the algorithm without bf16: SMOKE in f32, card against CPU.  Adam's
    # first update is about lr an element, within the parameters' bound
    # of 1e-4 * max(1, max|p|) at lr 1e-4; so the updates themselves are
    # held: per leaf within 2% of lr element by element and 1% of the
    # CPU's update in norm, the CPU's update reaching lr / 2 in every leaf
    scfg = lm_configs.get_smoke(LM_ARCH)
    lr = 1e-4
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, scfg.vocab_size, (4, 33)))
    cpu_batch = (tok[:, :-1], tok[:, 1:],
                 torch.arange(32).expand(4, 32))
    init = transformer.decoder_init(scfg, seed, device="cpu")
    p0 = [t.clone() for t in leaves(init)]
    trees = {}
    for dev in ("cpu", "cuda"):
        tree = params_on(init, dev)
        step = make_lm_train_step(scfg, lr=lr)
        trees[dev], _, _ = step(tree, adam_init(tree),
                                *(x.to(dev) for x in cpu_batch))
    errs, upd_err, upd_rel = [], 0.0, 0.0
    for i, (c, p, q) in enumerate(zip(leaves(trees["cuda"]),
                                      leaves(trees["cpu"]), p0)):
        c, p = c.detach().cpu(), p.detach()
        errs.append(_check_close(f"lm_train smoke leaf {i}", c, p))
        d_card, d_cpu = c - q, p - q
        err = (d_card - d_cpu).abs().max().item()
        rel = ((d_card - d_cpu).norm() / d_cpu.norm()).item()
        if not (d_cpu.abs().max().item() >= lr / 2 and err <= 2e-2 * lr
                and rel <= 1e-2):
            raise RuntimeError(
                f"lm_train smoke leaf {i}: update on the card against the "
                f"CPU's: max abs error {err} (limit {2e-2 * lr}), relative "
                f"norm {rel} (limit 1e-2), CPU's largest "
                f"{d_cpu.abs().max().item()} (at least {lr / 2})")
        upd_err, upd_rel = max(upd_err, err), max(upd_rel, rel)
    row["smoke_f32_card_vs_cpu"] = {
        "max_abs_err": max(e for e, _ in errs),
        "tolerance": min(t for _, t in errs), "leaves": len(errs),
        "update_max_abs_err": upd_err, "update_tolerance": 2e-2 * lr,
        "update_max_rel_norm_err": upd_rel, "lr": lr}
    print(f"lm_train smoke f32: one step on the card against the CPU, "
          f"{len(errs)} leaves: parameters within "
          f"{row['smoke_f32_card_vs_cpu']['max_abs_err']:.3e}, updates "
          f"within {upd_err:.3e} (limit {2e-2 * lr:.1e}) and {upd_rel:.3e} "
          f"of their norm (limit 1e-2)", flush=True)
    return row


@contextlib.contextmanager
def _moe_routes():
    """While inside, record each MoE layer call's expert ids and kept
    mask (``models.moe.route`` / ``dispatch`` called through)."""
    seen = []
    route, dispatch = lm_moe.route, lm_moe.dispatch

    def spy_route(p, x, cfg):
        gate, idx = route(p, x, cfg)
        seen.append({"idx": idx})
        return gate, idx

    def spy_dispatch(x, idx, e, cap):
        out = dispatch(x, idx, e, cap)
        seen[-1].update(keep=out[2], capacity=cap)
        return out

    lm_moe.route, lm_moe.dispatch = spy_route, spy_dispatch
    try:
        yield seen
    finally:
        lm_moe.route, lm_moe.dispatch = route, dispatch


def _route_row(call, num_experts: int) -> dict:
    idx, keep = call["idx"], call["keep"]
    return {"tokens": idx.shape[0] * idx.shape[1],
            "capacity": call["capacity"],
            "per_expert": torch.bincount(idx.flatten(),
                                         minlength=num_experts).tolist(),
            "kept_share": keep.float().mean().item()}


def _serving_model(arch: str, layers_: int, seed: int):
    cfg = lm_configs.get_config(arch).with_(num_layers=layers_)
    params = lm.load_serving_params(
        transformer.decoder_init(cfg, seed, device="cuda",
                                 dtype=torch.bfloat16), cfg)
    n = sum(t.numel() for t in leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device="cuda")
    print(f"{arch}: full width, {layers_} layers, {n} bf16 parameters "
          f"({n * 2 / 2**30:.2f} GiB)", flush=True)
    return cfg, params, n, gen, tokens


def _kernel10_rows(gen, mlp, label: str, runs: dict) -> list:
    """Kernel 10 on ``mlp``'s weights at a serving path's prefill and
    decode shapes, against its plain version and beside the plain path's
    MLP; each row's launches are those of the path's first kernels' run."""
    w = (mlp["wg"], mlp["wu"], mlp["wd"])
    cases = [swiglu_case(gen, f"swiglu_fwd {label} prefill",
                         LM_BATCH * LM_PROMPT, w, "silu", torch.bfloat16,
                         "prefill"),
             swiglu_case(gen, f"swiglu_fwd {label} decode", LM_BATCH, w,
                         "silu", torch.bfloat16, "decode")]
    rows = kernel_phase(cases)
    run = runs["kernels"][0]
    for row, c in zip(rows, cases):
        row["launches"] = run[f"{c['path']}_launches"]
        row["on_main_path"] = True
    del cases
    return rows


def moe_phase(seed: int) -> tuple[dict, list]:
    """The MoE family at full width.  deepseek-moe-16b, 2 layers, bf16:
    the kernels' path (the shared experts through kernel 10) against the
    plain path, teacher-forced, at DESIGN.md §4's bound; both timed
    through ``serve.lm``; kernel 10 at the shared experts' shapes; then 1 +
    3 training steps from f32 master weights.  phi3.5-moe, 1 layer, on the
    plain path (no shared expert, so no kernel): prefill + 4 decode steps,
    finite logits, the prefill against the forward, the expert counts."""
    cfg, params, n, gen, tokens = _serving_model(MOE_ARCH, 2, seed)
    e = cfg.moe.num_experts
    with _moe_routes() as routes:
        forced = lm_forced_pair("moe", cfg, params, tokens, LM_DECODE)
    prefill_routes = [_route_row(c, e) for c in routes[:cfg.num_layers]]
    print(f"moe {MOE_ARCH} prefill routing (layer 0 of the plain run): "
          f"{prefill_routes[0]}", flush=True)
    runs = family_serve("moe", cfg, params, tokens, _text_positions(tokens),
                        LM_MAX_LEN)
    shared = transformer.layer_params(params["layers"], 0)["moe"]["shared"]
    krows = _kernel10_rows(gen, shared, "moe shared", runs)
    row = {"arch": MOE_ARCH, "layers": 2, "parameters": n,
           "teacher_forced": forced, "serve": runs,
           "prefill_routing": prefill_routes}
    del params, shared
    torch.cuda.empty_cache()
    tparams = transformer.decoder_init(cfg, seed, device="cuda")
    for t in leaves(tparams):
        t.requires_grad_()
    row["train"] = lm_train_run(
        "moe train", cfg, tparams, _lm_batch(cfg, gen, LM_BATCH, LM_PROMPT),
        MOE_TRAIN_STEPS)
    del tparams
    torch.cuda.empty_cache()
    # phi3.5-moe: 16 experts of 6400, top-2, no shared expert
    pcfg, params, pn, _, tokens = _serving_model(PHI_ARCH, 1, seed)
    with _moe_routes() as routes:
        outs, _ = family_forced_run(pcfg, params, tokens,
                                    _text_positions(tokens), PHI_DECODE,
                                    LM_MAX_LEN, False)
    for i, o in enumerate(outs):
        if not torch.isfinite(o).all():
            raise RuntimeError(f"phi step {i}: non-finite logits")
    with torch.inference_mode():
        full = transformer.forward_train(
            pcfg, params, tokens,
            torch.arange(LM_PROMPT, device="cuda").expand(LM_BATCH,
                                                          LM_PROMPT))
    err, tol, cos = _check_bf16("phi prefill against forward", outs[0],
                                full[:, -1].float())
    phi_routes = _route_row(routes[0], pcfg.moe.num_experts)
    print(f"moe {PHI_ARCH}: prefill + {PHI_DECODE} decode steps finite, "
          f"prefill within {err:.3e} of the forward (tolerance {tol:.3e}, "
          f"cosine {cos:.6f}); prefill routing {phi_routes}", flush=True)
    row["phi"] = {"arch": PHI_ARCH, "layers": 1, "parameters": pn,
                  "prefill_vs_forward": {"max_abs_err": err,
                                         "tolerance": tol, "cosine": cos},
                  "prefill_routing": phi_routes,
                  "decode_routing": [_route_row(c, pcfg.moe.num_experts)
                                     for c in routes[1:]]}
    del params, full
    torch.cuda.empty_cache()
    return row, krows


def qwen110b_phase(seed: int) -> tuple[dict, list]:
    """qwen1.5-110b at full width (QKV bias), 2 layers, bf16: prefill + 8
    decode steps, the kernels' path against the plain path at DESIGN.md
    §4's bound, both timed through ``serve.lm``; kernel 10 at D 8192, F
    49152 against its plain version, beside the plain path's MLP."""
    cfg, params, n, gen, tokens = _serving_model(QWEN_ARCH, 2, seed)
    forced = lm_forced_pair("qwen110b", cfg, params, tokens, QWEN_DECODE)
    runs = family_serve("qwen110b", cfg, params, tokens,
                        _text_positions(tokens), LM_MAX_LEN, QWEN_DECODE)
    krows = _kernel10_rows(gen, transformer.layer_params(
        params["layers"], 0)["mlp"], "qwen110b", runs)
    del params
    torch.cuda.empty_cache()
    return {"arch": QWEN_ARCH, "layers": 2, "parameters": n,
            "teacher_forced": forced, "serve": runs}, krows


# the families of item 14d: served at full width and depth, trained at
# full width with depth cut
FAMILY_ARCHS = ("qwen2-vl-2b", "zamba2-1.2b", "rwkv6-3b", "whisper-medium")
FAMILY_TRAIN_LAYERS = {"qwen2-vl-2b": 2, "zamba2-1.2b": 6, "rwkv6-3b": 2,
                       "whisper-medium": 2}
FAMILY_TRAIN_STEPS = 2
# whisper: 30 s of audio (1,500 encoder frames); its decoder's context
WHISPER_FRAMES, WHISPER_MAX_LEN = 1500, 448
# qwen2-vl: text, a 16 x 16 image block, text (512 tokens)
VL_TEXT, VL_GRID = 128, (16, 16)
# the hybrid's SSD chunk where its forward runs over prompt + decoded
# tokens (528 = 33 x 16), and its prefill beside it: in bf16 the chunk
# moves work between C B^T rounded to bf16 and the f32 state, so the
# decode check holds prefill and forward at one chunk (the serving
# timings run the default 128; the gap between the two chunks is printed)
FORWARD_SSD_CHUNK = 16
# the hybrid's bf16 decode (the O(1) recurrence never forms C B^T) against
# its chunked forward (C B^T rounded to bf16): JAX's own gap at the SMOKE
# config is past §4's 3e-2 (tests/test_torch_hybrid.py::
# test_bf16_decode_gap_is_the_references); held at 6e-2 (cosine 0.999
# kept), and in f32 (family_f32_check) within 1e-3
HYBRID_DECODE_BOUND = 6e-2
# zamba2 and rwkv6 on seeded weights amplify rounding with depth (the
# ``depth_sweep`` rows of this phase record it): in bf16, zamba2's logits
# at SSD chunk 128 and 16, and rwkv6's decode against its forward (the
# same arithmetic at another matmul shape), differ by a few percent of
# the largest logit at cut depth and by tens of percent at full depth,
# in f32 by ~1e-4 (``f32_full_depth``).  So their full-depth bf16
# comparisons are recorded, not gated; they are gated in bf16 at the
# depth below (zamba2: one shared-block site) and in f32 at full depth
# (decode against forward within 1e-3, kernels' path against plain
# within 1e-3)
BF16_GATED_DEPTH = {"hybrid": 6, "rwkv": 2}
# the cut depths of ``depth_sweep`` (full depth: ``family_checks``)
DEPTH_SWEEP = {"hybrid": (6, 12), "rwkv": (2, 8, 16)}


def vl_positions(b: int, n_text: int, grid: tuple, n_after: int,
                 device="cuda"):
    """Qwen2-VL's (t, h, w) positions: ``n_text`` text tokens, an image
    block of ``grid`` patches at one t (h and w running over the grid
    from the block's start), then ``n_after`` text tokens from the largest
    position + 1; (b, S, 3)."""
    text = torch.arange(n_text, device=device)[:, None].expand(n_text, 3)
    gh, gw = grid
    hh, ww = torch.meshgrid(torch.arange(gh, device=device),
                            torch.arange(gw, device=device), indexing="ij")
    img = torch.stack([torch.zeros_like(hh.flatten()), hh.flatten(),
                       ww.flatten()], 1) + n_text
    start = int(img.max()) + 1
    after = torch.arange(start, start + n_after,
                         device=device)[:, None].expand(n_after, 3)
    pos = torch.cat([text, img, after])
    return pos.expand(b, *pos.shape).contiguous()


def _family_inputs(cfg, gen, b: int, s: int):
    """A family's serving inputs on the card: prompt tokens (whisper:
    frames, N(0, 1) in the compute dtype) and ``pos_fn(t)``, the positions
    of the prefill (``t=None``) or of decode step t."""
    if cfg.family == "encdec":
        frames = torch.randn(b, WHISPER_FRAMES, cfg.d_model, generator=gen,
                             device="cuda").to(torch.bfloat16)
        return frames, lambda t: None
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    if cfg.family == "rwkv":
        return tokens, lambda t: None
    if cfg.family == "vlm":
        pos = vl_positions(b, VL_TEXT, VL_GRID,
                           s - VL_TEXT - VL_GRID[0] * VL_GRID[1])
        nxt = int(pos.max()) + 1
        return tokens, lambda t: pos if t is None else torch.full(
            (b, 1, 3), nxt + t, device="cuda")
    return tokens, _text_positions(tokens)


def _text_positions(tokens):
    """``pos_fn`` of a text prompt (B, S): 0..S-1, then S + t at decode
    step t."""
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    return lambda t: pos if t is None else torch.full(
        (b, 1), s + t, device=tokens.device)


def family_forced_run(cfg, params, inputs, pos_fn, steps: int, max_len: int,
                      use_pallas: bool, forced=None,
                      cache_dtype=torch.bfloat16, **prefill_kw):
    """Prefill (``prefill_kw``: the hybrid's ``ssd_chunk``) then ``steps``
    decode steps through the family's entry points (``models.api.
    family_fns``, which return logits), each step fed this run's greedy
    token or, with ``forced``, the given one.  Returns the prefill's
    last-position logits and every step's logits (f32, (B, V) each;
    whisper's prefill gives the placeholder (B, 1)) and the tokens fed."""
    fns = family_fns(cfg)
    kw = lm.kernel_kw(cfg, use_pallas)
    if cfg.family != "rwkv":  # rwkv keeps no KV cache
        kw["cache_dtype"] = cache_dtype
    outs, fed = [], []
    with torch.inference_mode():
        logits, state = fns.prefill(cfg, params, inputs, pos_fn(None),
                                    max_len, **kw, **prefill_kw)
        kw.pop("cache_dtype", None)
        outs.append(logits[:, -1].float())
        for t in range(steps):
            tok = forced[t] if forced is not None \
                else outs[-1].argmax(-1, keepdim=True)
            fed.append(tok)
            logits, state = fns.decode_step(cfg, params, tok, state,
                                            pos_fn(t), **kw)
            outs.append(logits[:, 0].float())
    return outs, fed


def _gaps(name: str, pairs, rel: float, gate: bool) -> dict:
    """Every pair's ``_bf16_gap``; with ``gate`` a pair past the bound
    raises, else it is recorded."""
    errs = [_bf16_gap(f"{name} {i}", got, want, rel)
            for i, (got, want) in enumerate(pairs)]
    bad = [i for i, e in enumerate(errs) if not e[3]]
    if gate and bad:
        e = errs[bad[0]]
        raise RuntimeError(f"{name}, position {bad[0]}: max abs error {e[0]}"
                           f" (tolerance {e[1]}), cosine {e[2]} (at least "
                           "0.999)")
    return {"max_abs_err": [e[0] for e in errs],
            "tolerance": [e[1] for e in errs],
            "cosine": [e[2] for e in errs], "bound": rel, "gated": gate,
            "within_bound": not bad}


def family_decode_vs_forward(name: str, cfg, params, inputs, pos_fn, outs,
                             fed, gate: bool = True) -> dict:
    """The decode steps' logits against ``forward_train`` over the same
    tokens (prompt + the tokens fed; whisper: the frames and the decoder
    tokens fed), every step at DESIGN.md §4's bf16 bound (the hybrid at
    ``HYBRID_DECODE_BOUND``); ``gate=False`` records instead of raising."""
    fns = family_fns(cfg)
    steps = len(fed)
    dec = torch.cat(fed, 1)
    kw = {}
    with torch.inference_mode():
        if cfg.family == "encdec":
            full = fns.forward(cfg, params, inputs, dec)
            pairs = [(outs[1 + i], full[:, i]) for i in range(steps)]
        else:
            tokens = torch.cat([inputs, dec], 1)
            pos = None
            if fns.has_positions:
                pos = torch.cat([pos_fn(None)] + [pos_fn(t)
                                                  for t in range(steps)], 1)
            if cfg.family == "hybrid":
                kw["ssd_chunk"] = FORWARD_SSD_CHUNK
            full = fns.forward(cfg, params, tokens, pos, **kw)
            s = inputs.shape[1]
            pairs = [(outs[i], full[:, s - 1 + i]) for i in range(steps + 1)]
        rel = HYBRID_DECODE_BOUND if cfg.family == "hybrid" else 3e-2
        row = _gaps(f"{name} decode against the forward",
                    [(got, want.float()) for got, want in pairs], rel, gate)
    del full
    print(f"{name} decode against forward_train over the same tokens "
          f"({'gated' if gate else 'not gated'}): max abs error "
          f"{max(row['max_abs_err']):.3e} (smallest tolerance "
          f"{min(row['tolerance']):.3e}), smallest cosine "
          f"{min(row['cosine']):.6f}, {len(pairs)} positions, within the "
          f"bound: {row['within_bound']}", flush=True)
    return row


def family_serve_run(cfg, params, inputs, pos_fn, steps: int,
                     use_pallas: bool, launches: int, max_len: int) -> dict:
    """``serve.lm.prefill_step`` then ``steps`` greedy ``decode_step``s,
    each part on the host clock around work that ends in a synchronise,
    the launch counters set to 0 just before each part and read just after
    (kernel 10 exactly ``launches`` times a prefill and a decode step on
    the kernels' path, never on the plain path); the peak memory."""
    b = inputs.shape[0]
    prompt = inputs.shape[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    nxt, state = lm.prefill_step(cfg, params, inputs, pos_fn(None), max_len,
                                 use_pallas=use_pallas)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_counts = ops.launch_counts()
    ops.reset_launch_counts()
    tok = nxt[:, None]
    t0 = time.perf_counter()
    for t in range(steps):
        tok, state = lm.decode_step(cfg, params, tok, state, pos_fn(t),
                                    use_pallas=use_pallas)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    decode_counts = ops.launch_counts()
    n = launches if use_pallas else 0
    check_launches(f"{cfg.name} prefill", prefill_counts,
                   {"fused_swiglu": n}, 1)
    check_launches(f"{cfg.name} decode", decode_counts,
                   {"fused_swiglu": n}, steps)
    return {"ms_per_prefill": t_prefill * 1e3,
            "prompt_tokens_per_s": b * prompt / t_prefill,
            "ms_per_decode_step": t_decode / steps * 1e3,
            "decode_tokens_per_s": b * steps / t_decode,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "prefill_launches": prefill_counts["fused_swiglu"],
            "decode_launches": decode_counts["fused_swiglu"]}


def _family_launches(cfg) -> int:
    """Kernel 10's launches a forward: every layer's MLP (dense, VLM), or
    its shared experts' (MoE, where it has them), the shared block at each
    of its sites (hybrid), none (rwkv, whisper)."""
    if cfg.family == "hybrid":
        return hybrid.num_attn_sites(cfg)
    if cfg.family == "moe":
        return cfg.num_layers if cfg.moe.num_shared else 0
    return cfg.num_layers if cfg.family in ("dense", "vlm") else 0


def family_checks(name: str, cfg, params, inputs, pos_fn, max_len: int,
                  gate: bool = True) -> dict:
    """The decode steps against the forward and, on a gated family, the
    kernels' path teacher-forced against the plain path, at §4's bound;
    ``gate=False`` records the gaps instead of raising (finite logits
    still required)."""
    chunk = {"ssd_chunk": FORWARD_SSD_CHUNK} if cfg.family == "hybrid" \
        else {}
    plain, fed = family_forced_run(cfg, params, inputs, pos_fn, LM_DECODE,
                                   max_len, False, **chunk)
    row = {"decode_vs_forward": family_decode_vs_forward(
        name, cfg, params, inputs, pos_fn, plain, fed, gate)}
    if chunk:
        # the serving prefill's chunk (128) against the check's, not gated
        with torch.inference_mode():
            at128, _ = family_fns(cfg).prefill(cfg, params, inputs,
                                               pos_fn(None), max_len)
        err, tol, cos, _ = _bf16_gap(f"{name} chunk 128", at128[:, -1],
                                     plain[0])
        row["prefill_chunk_128_vs_16"] = {"max_abs_err": err,
                                          "tolerance": tol, "cosine": cos}
        print(f"{name} bf16 prefill at SSD chunk 128 against chunk "
              f"{FORWARD_SSD_CHUNK} (not gated): max abs error {err:.3e} "
              f"(tolerance {tol:.3e}), cosine {cos:.6f}", flush=True)
        del at128
    if cfg.family in lm.GATED_FAMILIES:
        got, _ = family_forced_run(cfg, params, inputs, pos_fn, LM_DECODE,
                                   max_len, True, forced=fed, **chunk)
        forced = _gaps(f"{name} kernels against plain", list(zip(got, plain)),
                       3e-2, gate)
        forced["token_agreement"] = [
            float((g.argmax(-1) == p.argmax(-1)).float().mean())
            for g, p in zip(got, plain)]
        row["teacher_forced"] = forced
        print(f"{name} teacher-forced, kernels' path against plain "
              f"({'gated' if gate else 'not gated'}): max abs error "
              f"{max(forced['max_abs_err']):.3e} (smallest tolerance "
              f"{min(forced['tolerance']):.3e}), smallest cosine "
              f"{min(forced['cosine']):.6f}, within the bound: "
              f"{forced['within_bound']}; greedy tokens agree "
              f"{sum(forced['token_agreement']) / len(got):.3f}",
              flush=True)
        del got
    return row


def family_serve(name: str, cfg, params, inputs, pos_fn, max_len: int,
                 steps: int = LM_DECODE) -> dict:
    """Serving of any family, timed through ``serve.lm`` (prefill, then
    ``steps`` greedy decode steps: ``family_serve_run``): on a gated family
    the kernels' path and the plain path in turns (plain, kernels,
    kernels, plain), else the one path twice."""
    gated = cfg.family in lm.GATED_FAMILIES
    runs = {"plain": [], "kernels": []}
    order = ("plain", "kernels", "kernels", "plain") if gated \
        else ("plain", "plain")
    for path in order:
        r = family_serve_run(cfg, params, inputs, pos_fn, steps,
                             path == "kernels", _family_launches(cfg),
                             max_len)
        runs[path].append(r)
        print(f"{name} serve {path}: {r['ms_per_prefill']:.2f} ms per "
              f"prefill ({r['prompt_tokens_per_s']:.0f} prompt tokens/s), "
              f"{r['ms_per_decode_step']:.3f} ms per decode step "
              f"({r['decode_tokens_per_s']:.1f} tokens/s), peak "
              f"{r['peak_mib']:.0f} MiB, fused_swiglu launches "
              f"{r['prefill_launches']} + {r['decode_launches']}",
              flush=True)
    return runs


def family_f32_check(arch: str, layers_: int, seed: int,
                     rel: float = 1e-4) -> dict:
    """The algorithm without bf16 noise: ``arch`` at full width cut to
    ``layers_`` layers in f32 (cache too), 2 prompts of 128 tokens and 4
    decode steps, the kernels' path teacher-forced on the plain path's
    tokens, every logit within ``rel * max(1, max|plain|)``; the plain
    path's decode against its forward within 1e-3 of the largest logit."""
    cfg = lm_configs.get_config(arch).with_(num_layers=layers_,
                                             compute_dtype="float32")
    fns = family_fns(cfg)
    params = lm.load_serving_params(fns.init(cfg, seed, device="cuda"), cfg,
                                    serve_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    b, s = 2, 128
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    if cfg.family == "vlm":
        pos = vl_positions(b, 32, (8, 8), s - 32 - 64)
        nxt = int(pos.max()) + 1
        pos_fn = lambda t: pos if t is None else torch.full(  # noqa: E731
            (b, 1, 3), nxt + t, device="cuda")
    else:
        pos_fn = _text_positions(tokens)
    plain, fed = family_forced_run(cfg, params, tokens, pos_fn, 4, s + 8,
                                   False, cache_dtype=torch.float32)
    ops.reset_launch_counts()
    got, _ = family_forced_run(cfg, params, tokens, pos_fn, 4, s + 8, True,
                               forced=fed, cache_dtype=torch.float32)
    counts = ops.launch_counts()
    check_launches(f"{arch} f32", counts,
                   {"fused_swiglu": _family_launches(cfg)}, 5)
    errs = [_check_close(f"{arch} f32 step {i}", g, p, rel)
            for i, (g, p) in enumerate(zip(got, plain))]
    # the plain path's decode against its forward over the same tokens,
    # within 1e-3 of the largest logit (tests/test_models_smoke.py's bound)
    fns_kw = {"ssd_chunk": 4} if cfg.family == "hybrid" else {}
    with torch.inference_mode():
        full = fns.forward(cfg, params, torch.cat([tokens] + fed, 1),
                           torch.cat([pos_fn(None)] + [pos_fn(t)
                                                       for t in range(4)], 1),
                           **fns_kw)
    fwd = max((o - full[:, s - 1 + i]).abs().max().item()
              / max(1.0, full[:, s - 1 + i].abs().max().item())
              for i, o in enumerate(plain))
    if not fwd <= 1e-3:
        raise RuntimeError(f"{arch} f32 decode against forward: {fwd} of "
                           "the largest logit (at most 1e-3)")
    row = {"layers": layers_, "prompts": b, "prompt_len": s,
           "decode_steps": 4, "max_abs_err": max(e for e, _ in errs),
           "tolerance": min(t for _, t in errs),
           "decode_vs_forward_rel": fwd,
           "launches": counts["fused_swiglu"]}
    print(f"{arch} f32 check ({layers_} layers, full width): logits of the "
          f"kernels' path within {row['max_abs_err']:.3e} of the plain "
          f"path's (tolerance {row['tolerance']:.3e}), "
          f"{row['launches']} kernel 10 launches; decode against forward "
          f"{fwd:.3e} of the largest logit", flush=True)
    del params
    torch.cuda.empty_cache()
    return row


def family_train(name: str, arch: str, seed: int) -> dict:
    """``arch`` at full width cut to ``FAMILY_TRAIN_LAYERS``, f32 master
    weights and bf16 compute, one batch of 4 x 512 (whisper: 512 frames
    and 512 decoder tokens): every gradient leaf finite, then 1 +
    ``FAMILY_TRAIN_STEPS`` steps of ``make_lm_train_step`` with a falling
    loss (``lm_train_run``); the hybrid at its default SSD chunk of 128."""
    cfg = lm_configs.get_config(arch).with_(
        num_layers=FAMILY_TRAIN_LAYERS[arch])
    if cfg.is_encdec:
        cfg = cfg.with_(num_decoder_layers=FAMILY_TRAIN_LAYERS[arch])
    fns = family_fns(cfg)
    params = fns.init(cfg, seed, device="cuda")
    n = sum(t.numel() for t in leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    tokens, labels, pos = _lm_batch(cfg, gen, LM_BATCH, LM_PROMPT)
    if not fns.token_input:
        tokens = torch.randn(LM_BATCH, LM_PROMPT, cfg.d_model, generator=gen,
                             device="cuda")
    batch = [tokens, labels]
    if fns.positions_3d:
        batch.append(vl_positions(LM_BATCH, VL_TEXT, VL_GRID, LM_PROMPT
                                  - VL_TEXT - VL_GRID[0] * VL_GRID[1]))
    elif fns.has_positions:
        batch.append(pos)
    kw = {"ssd_chunk": 128} if cfg.family == "hybrid" else {}
    loss, grads = lm_grads(cfg, params, batch, 1, **kw)
    bad = [i for i, g in enumerate(grads) if not torch.isfinite(g).all()]
    if bad or not math.isfinite(loss.item()):
        raise RuntimeError(f"{name}: loss {loss.item()}, non-finite "
                           f"gradient leaves {bad}")
    norm = global_norm(grads).item()
    del grads
    print(f"{name}: {arch} at full width, {FAMILY_TRAIN_LAYERS[arch]} "
          f"layers, {n} f32 parameters; first gradient finite in all "
          f"{len(leaves(params))} leaves, global norm {norm:.6f}",
          flush=True)
    row = lm_train_run(name, cfg, params, batch, FAMILY_TRAIN_STEPS, **kw)
    row.update(arch=arch, layers=FAMILY_TRAIN_LAYERS[arch], parameters=n,
               first_grad_norm=norm, grads_finite=True, **kw)
    del params, batch
    torch.cuda.empty_cache()
    return row


def depth_sweep(arch: str, seed: int) -> list:
    """bf16 rounding against depth, recorded (not gated), on 4 x 512
    prompts at each depth of ``DEPTH_SWEEP``: zamba2's last-position
    logits at SSD chunk 128 against ``FORWARD_SSD_CHUNK``; rwkv6's 8
    decode steps after a prefill against its forward over the same
    tokens.  Each row: the largest gap over ``max(1, max|logit|)`` and
    the smallest cosine."""
    base = lm_configs.get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    rows = []
    for depth in DEPTH_SWEEP[base.family]:
        cfg = base.with_(num_layers=depth)
        params = lm.load_serving_params(family_fns(cfg).init(
            cfg, seed, device="cuda", dtype=torch.bfloat16), cfg)
        tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 8),
                               generator=gen, device="cuda")
        prompt = tokens[:, :LM_PROMPT]
        with torch.inference_mode():
            if cfg.family == "hybrid":
                pos = _text_positions(prompt)(None)
                pairs = [tuple(hybrid.forward_train(
                    cfg, params, prompt, pos, ssd_chunk=c)[:, -1]
                    for c in (128, FORWARD_SSD_CHUNK))]
            else:
                full = rwkv.forward_train(cfg, params, tokens)
                _, st = rwkv.prefill(cfg, params, prompt)
                pairs = []
                for t in range(8):
                    i = LM_PROMPT + t
                    lg, st = rwkv.decode_step(cfg, params,
                                              tokens[:, i:i + 1], st)
                    pairs.append((lg[:, 0], full[:, i]))
        gaps = [((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1.0)).item()
                for a, b in pairs]
        cos = [torch.nn.functional.cosine_similarity(
            a.float().flatten(), b.float().flatten(), dim=0).item()
            for a, b in pairs]
        rows.append({"layers": depth, "max_rel_gap": max(gaps),
                     "min_cosine": min(cos)})
        print(f"families {arch} depth sweep (bf16, not gated): {depth} "
              f"layers, gap {max(gaps):.4f} of the largest logit, cosine "
              f"{min(cos):.6f}", flush=True)
        del params, pairs
        torch.cuda.empty_cache()
    return rows


def family_smoke_card_vs_cpu(arch: str, seed: int) -> dict:
    """The SMOKE config's ``lm_loss`` in f32 on the card against the CPU on
    one tree and batch (2 x 16; the hybrid at SSD chunk 8), within
    ``1e-4 * max(1, |cpu|)``."""
    cfg = lm_configs.get_smoke(arch)
    fns = family_fns(cfg)
    tree = fns.init(cfg, seed, device="cpu")
    rng = np.random.default_rng(seed)
    b, s = 2, 16
    x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))) \
        if fns.token_input else torch.from_numpy(
            rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32))
    batch = [x, torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))]
    if fns.has_positions:
        pos = torch.arange(s).expand(b, s)
        batch.append(pos[..., None].expand(b, s, 3) if fns.positions_3d
                     else pos)
    kw = {"ssd_chunk": 8} if cfg.family == "hybrid" else {}
    with torch.no_grad():
        cpu = fns.loss(cfg, tree, *batch, **kw).item()
        card = fns.loss(cfg, params_on(tree, "cuda"),
                        *(t.to("cuda") for t in batch), **kw).item()
    err, tol = abs(card - cpu), 1e-4 * max(1.0, abs(cpu))
    if not err <= tol:
        raise RuntimeError(f"{arch} SMOKE lm_loss: card {card} against CPU "
                           f"{cpu} (tolerance {tol})")
    return {"cpu": cpu, "card": card, "abs_err": err, "tolerance": tol}


def families_phase(seed: int) -> tuple[dict, list]:
    """Item 14d's four families at the full width of their configs, bf16
    weights from the seed: qwen2-vl (28 layers; M-RoPE positions for a 16
    x 16 image block between text), zamba2 (38 Mamba2 layers, the shared
    block at 6 sites), rwkv6 (32 layers) and whisper (24 + 24; 1,500
    frames) each serve 4 prompts (512 tokens) and 16 greedy decode steps
    (``family_checks``, gated at full depth but for zamba2 and rwkv6,
    whose bf16 noise grows with depth: ``BF16_GATED_DEPTH``;
    ``family_serve``), kernel 10 at the VLM's and the hybrid's MLP shapes
    against its plain version, the 2-layer (qwen2-vl) and 6-layer (zamba2)
    f32 checks, zamba2 and rwkv6 gated in bf16 at cut depth and in f32 at
    full depth, training at cut depth, the SMOKE loss card against CPU.
    Returns the phase's row and kernel 10's rows for the ``kernels``
    line."""
    out, krows = {}, []
    for arch in FAMILY_ARCHS:
        cfg = lm_configs.get_config(arch)
        fns = family_fns(cfg)
        t0 = time.perf_counter()
        params = lm.load_serving_params(
            fns.init(cfg, seed, device="cuda", dtype=torch.bfloat16), cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n = sum(t.numel() for t in leaves(params))
        gen = torch.Generator(device="cuda").manual_seed(seed)
        inputs, pos_fn = _family_inputs(cfg, gen, LM_BATCH, LM_PROMPT)
        max_len = WHISPER_MAX_LEN if cfg.is_encdec else LM_MAX_LEN
        print(f"families {arch} ({cfg.family}): full width and depth, {n} "
              f"bf16 parameters ({n * 2 / 2**30:.2f} GiB), drawn in "
              f"{init_s:.2f} s; inputs {tuple(inputs.shape)}, "
              f"{LM_DECODE} decode steps", flush=True)
        name = f"families {arch}"
        row = {"arch": arch, "family": cfg.family, "parameters": n,
               "init_s": init_s, "layers": cfg.num_layers
               + cfg.num_decoder_layers,
               **family_checks(name, cfg, params, inputs, pos_fn, max_len,
                               gate=cfg.family not in BF16_GATED_DEPTH),
               "serve": family_serve(name, cfg, params, inputs, pos_fn,
                                     max_len)}
        if cfg.family == "vlm":
            mlp = transformer.layer_params(params["layers"], 0)["mlp"]
        elif cfg.family == "hybrid":
            mlp = params["shared"]["mlp"]
        else:
            mlp = None
        if mlp is not None:
            krows += _kernel10_rows(gen, mlp, arch, row["serve"])
        del params, inputs, mlp
        torch.cuda.empty_cache()
        depth = BF16_GATED_DEPTH.get(cfg.family)
        if depth:
            cut = cfg.with_(num_layers=depth)
            params = lm.load_serving_params(
                fns.init(cut, seed, device="cuda", dtype=torch.bfloat16),
                cut)
            inputs, pos_fn = _family_inputs(cut, gen, LM_BATCH, LM_PROMPT)
            row["bf16_gated_cut_depth"] = family_checks(
                f"{name} ({depth} layers)", cut, params, inputs, pos_fn,
                max_len)
            del params, inputs
            torch.cuda.empty_cache()
            row["f32_full_depth"] = family_f32_check(arch, cfg.num_layers,
                                                     seed, rel=1e-3)
            row["depth_sweep"] = depth_sweep(arch, seed)
        if cfg.family in ("vlm", "hybrid"):
            # the kernels' path at cut depth in f32 within 1e-4
            row["f32_check"] = family_f32_check(
                arch, 2 if cfg.family == "vlm" else cfg.attn_every, seed)
        row["train"] = family_train(f"families {arch} train", arch, seed)
        row["smoke_card_vs_cpu"] = family_smoke_card_vs_cpu(arch, seed)
        print(f"families {arch} SMOKE lm_loss card against CPU: "
              f"{row['smoke_card_vs_cpu']}", flush=True)
        out[arch] = row
    return out, krows


def _plans(it):
    """Endless StepPlans of ``it``, one epoch after another (each epoch
    packs with the iterator's current cost model)."""
    while True:
        yield from it


def _logged(plans, log: list):
    """The plans as the Trainer takes them, each plan's microbatches (bucket
    caps, real atoms, bonds, angles: host values) appended to ``log``."""
    for plan in plans:
        log.append([{"caps": (m.atom_cap, m.bond_cap, m.angle_cap),
                     "real": [int(x) for x in sizes]}
                    for m, sizes in zip(plan.micro, plan.micro_sizes)])
        yield plan


def accum_grad_check(params, cfg, tcfg, ds, plan, idx, caps) -> dict:
    """The summed gradients of a plan's microbatches (the accumulation
    step, each microbatch in its bucket) against the gradients of one batch
    of the same indices packed at ``caps`` (``capacity_for``) and against
    the plain path's summed gradients, every leaf within ``1e-4 * max(1,
    max|p|)``; under deterministic algorithms."""
    def summed(step_cfg):
        grad_step, _ = make_chgnet_accum_step_fns(step_cfg, tcfg)
        total = None
        for m in plan.micro:
            g, _ = grad_step(params, m.to("cuda"), plan.denoms)
            total = g if total is None else [a + b for a, b in zip(total, g)]
        return total

    with _deterministic():
        g_accum = summed(cfg)
        g_plain = summed(plain_config(cfg))
        big = build_device_batch(ds, idx, caps,
                                 num_crystal_slots=len(idx)).to("cuda")
        loss, _ = chgnet_loss_fn(params, cfg, big, tcfg.loss)
        g_big = grads_of(loss, params)
    row = {}
    for name, want in (("big_batch", g_big), ("plain_path", g_plain)):
        errs = [_check_close(f"summed micro grads vs {name} leaf {i}", a, b)
                for i, (a, b) in enumerate(zip(g_accum, want, strict=True))]
        row[f"{name}_max_abs_err"] = max(e for e, _ in errs)
        row[f"{name}_worst_err_over_tolerance"] = max(e / t for e, t in errs)
    row["grad_leaves"] = len(g_accum)
    return row


def balanced_phase(ds, caps, fixed_caps, seed: int, card: str,
                   prefetch_row: dict) -> dict:
    """Load-balanced training (DESIGN.md §6) at ``FAST_FUSED``: a
    ``BalancedBatchIterator`` (2 cost-sorted microbatches a step, each in
    its own bucket of ``caps``) through ``Prefetcher(device="cuda")`` into
    ``Trainer._step_plan`` with live cost-model refits every 2 steps, 1 +
    5 steps, kernels 2, 3 and 4a launched exactly twice ``PER_FORWARD`` a
    step; on the first plan the summed microbatch gradients against one
    batch of the same indices at ``fixed_caps`` and against the plain
    path (``accum_grad_check``); the refit model must reach the iterator
    through ``on_cost_model``.  Then 1 + 2 steps at ``FAST_FUSED_MIXED``
    through the same iterator, the loss scale and ``grads_finite`` of each
    step reported."""
    cfg = chgnet_mptrj.FAST_FUSED
    tcfg = TrainConfig(global_batch=TRAIN_BATCH, total_steps=100,
                       loss=chgnet_mptrj.LOSS, cost_refit_every=2)
    it = BalancedBatchIterator(ds, TRAIN_BATCH, 1, caps, num_micro=2,
                               seed=seed)
    tr = Trainer(cfg, tcfg, seed=seed, device="cuda")
    tr.on_cost_model = it.update_cost_model
    idx = np.random.default_rng(seed + 1).permutation(len(ds))[:TRAIN_BATCH]
    grads = accum_grad_check(tr.params, cfg, tcfg, ds, it.plan_step(idx),
                             idx, fixed_caps)
    mixed = Trainer(chgnet_mptrj.FAST_FUSED_MIXED,
                    dataclasses.replace(tcfg, cost_refit_every=0), seed=seed,
                    device="cuda")
    ladder = [(b.atoms, b.bonds, b.angles) for b in caps.buckets]
    rows = {}
    log: list = []
    pf = Prefetcher(_plans(it), depth=2, device="cuda")
    try:
        batches = _logged(iter(pf), log)
        for name, trainer, steps in (("FAST_FUSED balanced", tr, 5),
                                     ("FAST_FUSED_MIXED balanced", mixed,
                                      2)):
            trainer.train(itertools.islice(batches, 1))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            c0 = len(log)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            hist = trainer.train(itertools.islice(batches, steps))
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            counts = ops.launch_counts()
            bwd_counts = bwd_launch_counts()
            peak = torch.cuda.max_memory_allocated()
            peak_reserved = torch.cuda.max_memory_reserved()
            micro = log[c0:]
            if [len(p) for p in micro] != [2] * steps:
                raise RuntimeError(f"{name}: microbatches per step "
                                   f"{[len(p) for p in micro]}")
            check_launches(name, counts, PER_FORWARD, 2 * steps)
            check_bwd_launches(name, bwd_counts, PER_FORWARD, 2 * steps)
            for h in hist:
                if not (math.isfinite(h["loss"])
                        and math.isfinite(h["grad_norm"])):
                    raise RuntimeError(f"{name}: non-finite loss or grad "
                                       f"norm {h}")
            rows[name] = {
                "steps": steps, "micro_per_step": 2,
                "ms_per_step": elapsed / steps * 1e3,
                "crystals_per_s": TRAIN_BATCH * steps / elapsed,
                "peak_mem_bytes": peak, "peak_reserved_bytes": peak_reserved,
                "launches": counts,
                "micro": [[dict(m, bucket=ladder.index(m["caps"]))
                           for m in plan] for plan in micro],
                "losses": [h["loss"] for h in hist],
                "grad_norms": [h["grad_norm"] for h in hist],
                "loss_scales": [h.get("loss_scale") for h in hist],
                "grads_finite": [h.get("grads_finite") for h in hist],
            }
            # one traced step: device time and events against FAST_FUSED
            # prefetch's traced step
            prof = rows[name]["profile"] = profile_step(
                lambda: trainer.train(itertools.islice(batches, 1)), None,
                (), ("embedding_dense_backward",))
            prof["busy_share"] = prof["device_ms"] / rows[name][
                "ms_per_step"]
    finally:
        pf.close()
    if tr.cost_model is None or it.cost_model is not tr.cost_model:
        raise RuntimeError("the refit cost model did not reach the "
                           "iterator through on_cost_model")
    ref = prefetch_row.get("profile", {})
    row = rows["FAST_FUSED balanced"]
    row.update(grad_check=grads, cost_model=dataclasses.asdict(tr.cost_model),
               cost_samples=len(tr._cost_samples),
               prefetch_ms_per_step=prefetch_row["ms_per_step"],
               prefetch_crystals_per_s=prefetch_row["crystals_per_s"],
               prefetch_device_ms=ref.get("device_ms"),
               prefetch_device_events=ref.get("device_events"))
    for name, r in rows.items():
        prof = r["profile"]
        print(f"train {name} ({card}): {r['ms_per_step']:.2f} ms per "
              f"optimizer step, {r['crystals_per_s']:.1f} crystals/s, "
              f"traced step {prof['device_ms']:.2f} device ms in "
              f"{prof['device_events']} events (busy share "
              f"{prof['busy_share']:.2f}, embedding_dense_backward "
              f"{prof['kernels']['embedding_dense_backward']['device_ms']:.2f}"
              f" ms), peak {r['peak_mem_bytes'] / 2**20:.1f} MiB (reserved "
              f"{r['peak_reserved_bytes'] / 2**20:.1f}); FAST_FUSED "
              f"prefetch in this run: "
              f"{prefetch_row['ms_per_step']:.2f} ms, "
              f"{prefetch_row['crystals_per_s']:.1f} crystals/s, "
              f"{ref.get('device_ms')} device ms in "
              f"{ref.get('device_events')} events; launches "
              f"{r['launches']}; losses {r['losses']}, loss scales "
              f"{r['loss_scales']}, grads finite {r['grads_finite']}",
              flush=True)
        for s, plan in enumerate(r["micro"]):
            print(f"train {name} ({card}) step {s}: " + "; ".join(
                f"micro {i} bucket {m['bucket']}: atoms {m['real'][0]}/"
                f"{m['caps'][0]}, bonds {m['real'][1]}/{m['caps'][1]}, "
                f"angles {m['real'][2]}/{m['caps'][2]}"
                for i, m in enumerate(plan)), flush=True)
    print(f"train FAST_FUSED balanced ({card}): refit cost model "
          f"{row['cost_model']} from {row['cost_samples']} microbatch "
          f"times; summed microbatch gradients vs one batch at "
          f"capacity_for {grads['big_batch_max_abs_err']:.3g}, vs the plain "
          f"path {grads['plain_path_max_abs_err']:.3g} (worst err / "
          f"tolerance {grads['big_batch_worst_err_over_tolerance']:.3g}, "
          f"{grads['plain_path_worst_err_over_tolerance']:.3g})", flush=True)
    del tr, mixed
    torch.cuda.empty_cache()
    return rows


def _tagged_steps(ds, caps, n: int) -> list:
    """The batch of step s, a function of s alone (``BatchIterator`` seeded
    s), tagged with its indices: a resumed run sees the data an
    uninterrupted one saw."""
    return [next(iter(BatchIterator(ds, TRAIN_BATCH, 1, caps, seed=s,
                                    tag_indices=True))) for s in range(n)]


def _same_state(name: str, a, b) -> None:
    differ = [i for i, (x, y) in enumerate(zip(leaves(a.state()),
                                               leaves(b.state()),
                                               strict=True))
              if not torch.equal(x, y)]
    if differ:
        raise RuntimeError(f"{name}: {len(differ)} state leaves differ, "
                           f"first {differ[0]}")


def runtime_phase(ds, caps, seed: int, card: str, root: Path) -> dict:
    """The runtime (DESIGN.md §8) at ``FAST_FUSED``, batch 128, under
    deterministic algorithms: run A, 6 uninterrupted steps; run B with
    async checkpoints every 2 steps and a real SIGTERM at step 3 (the chaos
    monkey) must stop with ``PreemptionError``, a resume marker and a
    valid checkpoint, and a fresh Trainer restored from it must end at step
    6 with run A's state bit for bit; a run with rollback on divergence
    and ``nan@3,nan@4`` must roll back exactly once, quarantine the
    streak's indices, train on with finite losses and leave only files
    that verify; a bit flip in the newest file must make the restore fall
    back to the one before; the launcher (``python -m
    repro_torch.launch.train``) trains 8 steps with ``--balance cost
    --accum 2 --async-ckpt`` and resumes from its checkpoint to 12.  The
    sync save, the async save's loop-thread and flush times, the restore
    time and the checkpoint's bytes are reported."""
    cfg = chgnet_mptrj.FAST_FUSED

    def tcfg(**kw):
        return TrainConfig(global_batch=TRAIN_BATCH, total_steps=100,
                           loss=chgnet_mptrj.LOSS, **kw)

    tagged = _tagged_steps(ds, caps, 8)
    plain = [t.batch for t in tagged]
    row: dict = {}
    clock = time.perf_counter
    with _deterministic():
        ref = Trainer(cfg, tcfg(), seed=seed, device="cuda")
        ref.train(plain[:6])
        d = root / "sigterm"
        monkey = ChaosMonkey(ChaosSchedule.parse("sigterm@3"))
        with GracefulShutdown() as shutdown:
            run = Trainer(cfg, tcfg(), seed=seed, device="cuda",
                          ckpt_dir=str(d), ckpt_every=2, async_ckpt=True,
                          shutdown=shutdown)
            try:
                run.train(plain[:6], fault_injector=monkey)
                raise RuntimeError("SIGTERM at step 3 did not preempt")
            except PreemptionError as exc:
                preempted = exc.step
            run.close()
            marker = read_resume_marker(str(d))
            if not (preempted == 4 and marker and marker["step"] == 4
                    and latest_valid_step(str(d)) == 4):
                raise RuntimeError(f"preemption: step {preempted}, marker "
                                   f"{marker}, newest valid "
                                   f"{latest_valid_step(str(d))}")
            shutdown.requested = False
            res = Trainer(cfg, tcfg(), seed=seed + 1, device="cuda",
                          ckpt_dir=str(d), shutdown=shutdown)
            t0 = clock()
            if not res.maybe_restore() or res.step != 4:
                raise RuntimeError(f"restore gave step {res.step}")
            torch.cuda.synchronize()
            row["restore_ms"] = (clock() - t0) * 1e3
            res.train(plain[4:6])
        _same_state("SIGTERM resume against the uninterrupted run", ref, res)
        row["sigterm"] = {"preempted_at": preempted, "marker": marker,
                          "resumed_to": res.step, "bitwise_equal": True}
        path = Path(d) / f"ckpt_{4:010d}.msgpack"
        row["ckpt_bytes"] = path.stat().st_size
        # the save paths, timed on run A's final state
        torch.cuda.synchronize()
        t0 = clock()
        save_checkpoint(str(root / "sync"), 6, ref.state())
        row["sync_save_ms"] = (clock() - t0) * 1e3
        writer = AsyncCheckpointWriter(str(root / "async"))
        t0 = clock()
        writer.save(6, ref.state())
        t1 = clock()
        writer.flush()
        t2 = clock()
        writer.close()
        row["async_save_loop_ms"] = (t1 - t0) * 1e3
        row["async_flush_ms"] = (t2 - t1) * 1e3
        del ref, res, run

        # rollback on a NaN streak, launcher-style attempts
        d = root / "rollback"
        monkey = ChaosMonkey(ChaosSchedule.parse("nan@3,nan@4"),
                             ckpt_dir=str(d))
        history, rollbacks, quarantined, attempts = [], 0, set(), 0
        while True:
            attempts += 1
            if attempts > 4:
                raise RuntimeError("rollback run did not reach step 8")
            tr = Trainer(cfg, tcfg(rollback_on_divergence=True), seed=seed,
                         device="cuda", ckpt_dir=str(d), ckpt_every=2)
            tr.maybe_restore()
            history.extend(tr.train(monkey.wrap_batches(
                iter(tagged[tr.step:8]), start_step=tr.step)))
            rollbacks += tr.rollbacks
            quarantined |= tr.quarantined
            if tr.step >= 8:
                break
        nan_steps = [i for i, h in enumerate(history)
                     if not math.isfinite(h["loss"])]
        files = list_checkpoints(str(d))
        if not (rollbacks == 1 and quarantined and nan_steps == [3]
                and all(verify_checkpoint(str(d / f"ckpt_{s:010d}.msgpack"))
                        for s in files)):
            raise RuntimeError(f"rollback: {rollbacks} rollbacks, "
                               f"{len(quarantined)} quarantined, non-finite "
                               f"steps {nan_steps}, files {files}")
        row["rollback"] = {"rollbacks": rollbacks, "attempts": attempts,
                           "quarantined": len(quarantined),
                           "losses": [h["loss"] for h in history],
                           "lr_scale": float(tr.opt_state["lr_scale"]),
                           "checkpoints": files}
        # a bit flip in the newest file: the restore takes the one before
        newest = corrupt_newest_checkpoint(str(d), mode="bitflip", seed=seed)
        back = Trainer(cfg, tcfg(rollback_on_divergence=True), seed=seed,
                       device="cuda", ckpt_dir=str(d))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            restored = back.maybe_restore()
        if verify_checkpoint(newest) or not restored \
                or back.step != files[-2]:
            raise RuntimeError(f"bit flip in {newest}: restored step "
                               f"{back.step}, expected {files[-2]}")
        row["bitflip"] = {"corrupted": files[-1], "restored": back.step}
        del tr, back
    torch.cuda.empty_cache()

    # the launcher, resuming from its own checkpoint
    d = root / "launcher"
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    runs = []
    for steps in (8, 12):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--steps",
               str(steps), "--batch", str(TRAIN_BATCH), "--balance", "cost",
               "--accum", "2", "--conv-impl", "fused", "--ckpt", str(d),
               "--async-ckpt"]
        t0 = clock()
        out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=300)
        runs.append({"steps": steps, "s": clock() - t0,
                     "stdout": out.stdout.strip().splitlines()})
        if out.returncode or latest_valid_step(str(d)) != steps:
            raise RuntimeError(f"launcher to {steps} steps: rc "
                               f"{out.returncode}, newest valid checkpoint "
                               f"{latest_valid_step(str(d))}\n"
                               f"{out.stdout[-2000:]}{out.stderr[-4000:]}")
    if f"restored step 8 from {d}" not in runs[1]["stdout"]:
        raise RuntimeError(f"the launcher did not resume from step 8: "
                           f"{runs[1]['stdout']}")
    row["launcher"] = runs
    print(f"runtime ({card}): SIGTERM at step 3 -> preempted at "
          f"{preempted}, resumed to 6 bit for bit equal to the "
          f"uninterrupted run; checkpoint {row['ckpt_bytes']} bytes, sync "
          f"save {row['sync_save_ms']:.2f} ms, async save "
          f"{row['async_save_loop_ms']:.2f} ms on the loop thread + flush "
          f"{row['async_flush_ms']:.2f} ms, restore "
          f"{row['restore_ms']:.2f} ms", flush=True)
    print(f"runtime ({card}): nan@3,nan@4 -> {rollbacks} rollback, "
          f"{len(quarantined)} indices quarantined, losses "
          f"{row['rollback']['losses']}; bit flip in step {files[-1]}'s "
          f"file -> restored step {row['bitflip']['restored']}; launcher "
          f"{[(r['steps'], round(r['s'], 1)) for r in runs]} s: "
          f"{runs[1]['stdout'][-2:]}", flush=True)
    return row


# ---------------------------------------------------------------------------
# 11. data parallelism (DESIGN.md §6): a mesh of one rank over NCCL in this
# process, then two ranks that share the card over gloo
# ---------------------------------------------------------------------------

DP_STEPS = 3  # counted steps after one warm-up step
DP_RANKS = 2


def _dp_tcfg(**kw) -> TrainConfig:
    return TrainConfig(global_batch=TRAIN_BATCH, total_steps=100,
                       loss=chgnet_mptrj.LOSS, **kw)


def _dp_batches(ds, caps, num_devices: int, shard, seed: int,
                balanced: bool = False):
    """Endless batches (``BatchIterator``) or plans
    (``BalancedBatchIterator``, 2 microbatches) of one rank, epoch after
    epoch."""
    while True:
        if balanced:
            yield from BalancedBatchIterator(ds, TRAIN_BATCH, num_devices,
                                             caps, num_micro=2, seed=seed,
                                             shard=shard)
        else:
            yield from BatchIterator(ds, TRAIN_BATCH, num_devices, caps,
                                     seed=seed, shard=shard)


def _state_digest(tr) -> str:
    """sha256 of the trainer's parameters and optimizer state, bit for
    bit (one copy to the host per device)."""
    flat = leaves(tr.state())
    h = hashlib.sha256()
    for dev in sorted({str(x.device) for x in flat}):
        h.update(torch.cat([x.detach().reshape(-1).view(torch.uint8)
                            for x in flat if str(x.device) == dev])
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _precision_flags() -> None:
    """f32 products in full f32 (no TF32), bf16 cuBLAS sums in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the mixed tiers' plain bf16 products (torch.matmul, cuBLAS) sum in
    # f32, as the JAX package's do (DESIGN.md §4)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False


def _reduce_row(mesh, grads, how: str, timer) -> dict:
    """The gradient all-reduce of ``how`` on gradients of the model's
    shapes: collectives, bytes on the wire and the time ``timer`` gives."""
    n = sum(g.numel() for g in grads)
    calls = {"plain": len(grads), "bucketed": len(bucket_plan(grads)),
             "compressed": 1}[how]
    copies = [g.clone() for g in grads]
    return {"collectives": calls,
            "bytes": n * (2 if how == "compressed" else 4),
            "ms": timer(lambda: all_reduce_grads(copies, mesh, how))}


def _host_ms(fn, reps: int = 5) -> float:
    """Median host time of ``fn`` between two synchronises (a gloo
    collective on CUDA tensors runs through host memory)."""
    samples = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples[1:])


def dp_world1(ds, caps, seed: int, root: Path) -> dict:
    """Phase A: ``Trainer(mesh=)`` on a one-rank NCCL mesh against the
    single-device ``Trainer`` from the same parameters on the same batches,
    1 + ``DP_STEPS`` steps a ``grad_reduce``, under deterministic
    algorithms, the two trainers' steps in turns: plain and bucketed equal
    every step's metrics and every state leaf bit for bit (an all-reduce
    of one rank is a copy, /1 exact); compressed reduces the first step's
    gradient to its bf16 rounding bit for bit and keeps the metrics within
    DESIGN.md §4's bounds of the f32 run; the balanced path (2 plans of 2
    microbatches) bit for bit.  Reports ms a step of both, and the
    all-reduce's collectives, bytes and device time (CUDA events) a
    step."""
    cfg = chgnet_mptrj.FAST_FUSED
    mesh = init_data_mesh("cuda:0", rank=0, world_size=1,
                          init_method=f"file://{root}/nccl")
    if mesh.backend != "nccl":
        raise RuntimeError(f"world-1 mesh on {mesh.backend}, not nccl")
    rows = {}
    try:
        batches = list(itertools.islice(
            _dp_batches(ds, caps, 1, None, seed), 1 + DP_STEPS))
        with _deterministic():
            for how in GRAD_REDUCE:
                ref = Trainer(cfg, _dp_tcfg(grad_reduce=how), seed=seed,
                              device="cuda")
                dp = Trainer(cfg, _dp_tcfg(grad_reduce=how), seed=seed,
                             mesh=mesh)
                b0 = batches[0].to("cuda")
                loss, _ = chgnet_loss_fn(ref.params, cfg, b0,
                                         chgnet_mptrj.LOSS)
                grads = grads_of(loss, ref.params)
                row = _reduce_row(mesh, grads, how, _time_device)
                if how == "compressed":
                    red = all_reduce_grads([g.clone() for g in grads], mesh,
                                           how)
                    if not all(torch.equal(r, g.to(torch.bfloat16).float())
                               for r, g in zip(red, grads)):
                        raise RuntimeError("compressed: the reduced "
                                           "gradient is not the bf16 "
                                           "rounding of the f32 one")
                del b0, loss, grads
                h_ref, h_dp, t_ref, t_dp = [], [], 0.0, 0.0
                counts: dict = {}
                bwd_counts: dict = {}
                for i, b in enumerate(batches):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    h_ref += ref.train([b])
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    ops.reset_launch_counts()
                    h_dp += dp.train([b])
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    for k, v in ops.launch_counts().items():
                        counts[k] = counts.get(k, 0) + v
                    for k, v in bwd_launch_counts().items():
                        bwd_counts[k] = bwd_counts.get(k, 0) + v
                    if i:
                        t_ref += t1 - t0
                        t_dp += t2 - t1
                    if how != "compressed":
                        if h_ref[-1] != h_dp[-1]:
                            raise RuntimeError(f"world 1 {how} step {i}: "
                                               f"{h_dp[-1]} != {h_ref[-1]}")
                        _same_state(f"world 1 {how} step {i}", ref, dp)
                check_launches(f"world 1 {how}", counts, PER_FORWARD,
                               1 + DP_STEPS)
                check_bwd_launches(f"world 1 {how}", bwd_counts, PER_FORWARD,
                                   1 + DP_STEPS)
                if how == "compressed":
                    for a, b in zip(h_dp, h_ref):
                        if not (abs(a["loss"] - b["loss"])
                                <= 3e-2 * max(1.0, abs(b["loss"]))
                                and abs(a["grad_norm"] - b["grad_norm"])
                                <= 0.05 * b["grad_norm"]):
                            raise RuntimeError(f"compressed {a} against "
                                               f"f32 {b}")
                rows[how] = dict(
                    row, ms_per_step=t_dp / DP_STEPS * 1e3,
                    single_device_ms_per_step=t_ref / DP_STEPS * 1e3,
                    losses=[h["loss"] for h in h_dp],
                    f32_losses=[h["loss"] for h in h_ref],
                    grad_norms=[h["grad_norm"] for h in h_dp],
                    bitwise_equal=how != "compressed", launches=counts)
                del ref, dp
            ref = Trainer(cfg, _dp_tcfg(), seed=seed, device="cuda")
            dp = Trainer(cfg, _dp_tcfg(), seed=seed, mesh=mesh)
            losses = []
            for i, plan in enumerate(itertools.islice(
                    _dp_batches(ds, caps, 1, None, seed, True), 2)):
                a, b = ref.train([plan]), dp.train([plan])
                if a != b:
                    raise RuntimeError(f"world 1 balanced plan {i}: {b} != "
                                       f"{a}")
                _same_state(f"world 1 balanced plan {i}", ref, dp)
                losses.append(b[0]["loss"])
            rows["balanced"] = {"plans": 2, "bitwise_equal": True,
                                "losses": losses}
            del ref, dp
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return rows


def _dp_run(tr, batches, mesh, name: str, forwards: int) -> dict:
    """1 + ``DP_STEPS`` steps of one rank, the state's digest after each;
    the counted steps timed (host clock, synchronised) and their launches
    checked (``forwards`` forwards a step)."""
    digests, hist, elapsed = [], [], 0.0
    hist += tr.train(itertools.islice(batches, 1))
    digests.append(_state_digest(tr))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for _ in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist += tr.train(itertools.islice(batches, 1))
        torch.cuda.synchronize()
        elapsed += time.perf_counter() - t0
        digests.append(_state_digest(tr))
    counts = ops.launch_counts()
    check_launches(f"{name} rank {mesh.rank}", counts, PER_FORWARD,
                   forwards * DP_STEPS)
    check_bwd_launches(f"{name} rank {mesh.rank}", bwd_launch_counts(),
                       PER_FORWARD, forwards * DP_STEPS)
    return {"digests": digests, "history": hist, "launches": counts,
            "ms_per_step": elapsed / DP_STEPS * 1e3,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}


def _dp_rank_runs(mesh, seed: int) -> dict:
    """Phase B on one rank (``DP_RANKS`` ranks sharing the card over
    gloo), FAST_FUSED at a global batch of ``TRAIN_BATCH``: run 1,
    ``BatchIterator`` shards, bucketed, 1 + ``DP_STEPS`` steps; run 2,
    ``BalancedBatchIterator`` plans (2 microbatches), its first plan's
    summed gradient against one batch of the same indices at
    ``capacity_for``, then 1 + ``DP_STEPS`` steps; run 3, ``elastic_train``
    to 5 steps with position 1 dropped at step 2."""
    cfg = chgnet_mptrj.FAST_FUSED
    ds = make_dataset(SyntheticConfig())
    # capacities a device: ceil(batch / devices) crystals, as the launcher
    caps = ladder_for(ds, -(-TRAIN_BATCH // DP_RANKS))
    res = {}
    tr = Trainer(cfg, _dp_tcfg(), seed=seed, mesh=mesh)
    res["run1"] = _dp_run(tr, _dp_batches(ds, caps, DP_RANKS, mesh.rank,
                                          seed), mesh, "dp run 1", 1)
    g = grads_of(chgnet_loss_fn(tr.params, cfg, next(iter(BatchIterator(
        ds, TRAIN_BATCH, DP_RANKS, caps, seed=seed, shard=mesh.rank)))
        .to(mesh.device), chgnet_mptrj.LOSS)[0], tr.params)
    res["run1"]["all_reduce"] = _reduce_row(mesh, g, "bucketed", _host_ms)
    del tr, g

    tr = Trainer(cfg, _dp_tcfg(), seed=seed, mesh=mesh)
    idx = np.random.default_rng(seed + 1).permutation(len(ds))[:TRAIN_BATCH]
    plan = BalancedBatchIterator(ds, TRAIN_BATCH, DP_RANKS, caps,
                                 num_micro=2, shard=mesh.rank).plan_step(idx)
    grad_step, _ = make_chgnet_accum_step_fns(cfg, _dp_tcfg(), mesh=mesh)
    total = None
    for m in plan.micro:
        gm, _ = grad_step(tr.params, m.to(mesh.device), plan.denoms)
        total = gm if total is None else [a + b for a, b in zip(total, gm)]
    big = build_device_batch(ds, idx, capacity_for(ds, TRAIN_BATCH),
                             num_crystal_slots=TRAIN_BATCH).to(mesh.device)
    g_big = grads_of(chgnet_loss_fn(tr.params, cfg, big,
                                    chgnet_mptrj.LOSS)[0], tr.params)
    rel = float(global_norm([a - b for a, b in zip(total, g_big)])
                / global_norm(g_big))
    if not rel <= 1e-4:
        raise RuntimeError(f"rank {mesh.rank}: summed micro gradients "
                           f"{rel} relative from one batch at capacity_for")
    del total, big, g_big
    res["run2"] = _dp_run(tr, _dp_batches(ds, caps, DP_RANKS, mesh.rank,
                                          seed, True), mesh, "dp run 2", 2)
    res["run2"]["grad_rel_err"] = rel
    del tr

    tr = Trainer(cfg, _dp_tcfg(), seed=seed, mesh=mesh)

    def batches_fn(num_devices):
        return itertools.islice(_dp_batches(ds, caps, num_devices,
                                            tr.mesh.rank, seed, True), 5)

    hist = elastic_train(tr, batches_fn, max_steps=5,
                         fault_injector=DeviceDropInjector(2, 1))
    res["run3"] = {"steps": tr.step, "history": len(hist),
                   "losses": [h["loss"] for h in hist],
                   "devices": tr.num_devices}
    return res


def _dp_rank(rank: int, init_method: str, seed: int, results) -> None:
    """A spawned rank of phase B: cuda:0 over gloo (NCCL refuses two ranks
    on one device), its results or its traceback to ``results``."""
    try:
        _precision_flags()
        build.load_libraries()
        mesh = init_data_mesh("cuda:0", rank=rank, world_size=DP_RANKS,
                              init_method=init_method, backend="gloo")
        try:
            res = _dp_rank_runs(mesh, seed)
        finally:
            dist.destroy_process_group()
        results.put((rank, res))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def _dp_two_shard_reference(ds, caps, seed: int) -> dict:
    """Run 1's first step without a mesh: the two shards one after the
    other on the card, their gradients and losses averaged."""
    cfg = chgnet_mptrj.FAST_FUSED
    params = params_on(chgnet.chgnet_init(seed, cfg), "cuda")
    shards = next(iter(BatchIterator(ds, TRAIN_BATCH, DP_RANKS, caps,
                                     seed=seed)))
    losses, grads = [], []
    for b in shards:
        loss, _ = chgnet_loss_fn(params, cfg, b.to("cuda"),
                                 chgnet_mptrj.LOSS)
        losses.append(loss.detach())
        grads.append(grads_of(loss, params))
    mean = [sum(gs) / DP_RANKS for gs in zip(*grads)]
    return {"loss": float(sum(losses) / DP_RANKS),
            "grad_norm": float(global_norm(mean))}


def dp_two_ranks(ds, seed: int, root: Path) -> dict:
    """Phase B: ``DP_RANKS`` spawned processes share the card over gloo
    (``_dp_rank_runs``); the replicas must be equal bit for bit after
    every step of runs 1 and 2, run 1's first step must agree with the
    two shards run here one after the other within ``1e-4 * max(1, |p|)``,
    and run 3 must finish its 5 steps on one rank, the dropped rank
    exiting 0.  Any child's exception, non-zero exit or timeout raises."""
    caps = ladder_for(ds, -(-TRAIN_BATCH // DP_RANKS))
    want = _dp_two_shard_reference(ds, caps, seed)
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_dp_rank, args=(
        r, f"file://{root}/gloo", seed, results)) for r in range(DP_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    out: dict = {}
    try:
        while len(out) < DP_RANKS:
            rank, res = results.get(timeout=300)
            out[rank] = res
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    wall = time.perf_counter() - t0
    for rank, res in out.items():
        if isinstance(res, str):
            raise RuntimeError(f"dp rank {rank} failed:\n{res}")
    codes = [p.exitcode for p in procs]
    if codes != [0] * DP_RANKS:
        raise RuntimeError(f"dp ranks exited {codes}")
    r0, r1 = out[0], out[1]
    for run in ("run1", "run2"):
        if r0[run]["digests"] != r1[run]["digests"]:
            raise RuntimeError(f"dp {run}: the replicas differ")
        if r0[run]["history"] != r1[run]["history"]:
            raise RuntimeError(f"dp {run}: the ranks' metrics differ")
    first = r0["run1"]["history"][0]
    for k in ("loss", "grad_norm"):
        if not abs(first[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])):
            raise RuntimeError(f"dp run 1 step 1 {k}: {first[k]} against "
                               f"two shards in one process {want[k]}")
    e0, e1 = r0["run3"], r1["run3"]
    if not (e0["steps"] == 5 and e0["history"] == 5 and e0["devices"] == 1
            and all(math.isfinite(x) for x in e0["losses"])
            and e1["steps"] == 2):
        raise RuntimeError(f"dp elastic: rank 0 {e0}, rank 1 {e1}")
    return {"wall_s": wall, "two_shard_reference": want,
            "ranks": {r: {run: {k: v for k, v in out[r][run].items()
                                if k != "digests"}
                          for run in ("run1", "run2", "run3")}
                      for r in out}}


def dp_phase(ds, ladder, seed: int, card: str, root: Path) -> dict:
    """Phase A (``dp_world1``) then phase B (``dp_two_ranks``); prints
    their numbers, labelled with the card."""
    t0 = time.perf_counter()
    world1 = dp_world1(ds, ladder, seed, root)
    t1 = time.perf_counter()
    two = dp_two_ranks(ds, seed, root)
    row = {"card": card, "world1": world1, "two_ranks": two,
           "world1_s": t1 - t0, "two_ranks_s": time.perf_counter() - t1}
    for how in GRAD_REDUCE:
        r = world1[how]
        print(f"dp world 1 nccl {how} ({card}): {r['ms_per_step']:.2f} ms "
              f"a step against the single-device Trainer's "
              f"{r['single_device_ms_per_step']:.2f}; all-reduce "
              f"{r['collectives']} collectives, {r['bytes']} bytes, "
              f"{r['ms']:.4f} device ms a step; bit for bit "
              f"{r['bitwise_equal']}", flush=True)
    for r, runs in two["ranks"].items():
        for run in ("run1", "run2"):
            x = runs[run]
            ar = x.get("all_reduce")
            print(f"dp two processes sharing one H100, gloo, rank {r} "
                  f"{run} ({card}): {x['ms_per_step']:.2f} ms a step, peak "
                  f"{x['peak_mib']:.1f} MiB, launches {x['launches']}"
                  + (f"; bucketed all-reduce {ar['collectives']} "
                     f"collectives, {ar['bytes']} bytes, {ar['ms']:.2f} "
                     "host ms" if ar else ""), flush=True)
    print(f"dp elastic ({card}): rank 0 {two['ranks'][0]['run3']}, rank 1 "
          f"{two['ranks'][1]['run3']}; phase A {row['world1_s']:.1f} s, "
          f"phase B {row['two_ranks_s']:.1f} s", flush=True)
    return row


# ---------------------------------------------------------------------------
# the pipeline phase: GPipe over torch.distributed (distributed.pipeline)
# ---------------------------------------------------------------------------

# llama3-8b at full width, 8 of its 32 layers pipelined over 4 ranks that
# share the card over gloo (2 layers a stage), 8 microbatches of 1 x 512
# hidden states at positions 0..511
PIPE_RANKS, PIPE_LAYERS, PIPE_MICRO, PIPE_TOKENS = 4, 8, 8, 512
PIPE_HOPS = 10  # timed ring hops


def _pipe_layers(cfg, seed: int) -> dict:
    """The 8 layers' stacked f32 weights drawn from ``seed`` on the card:
    every rank draws the same tree (no embedding table)."""
    mk = layers.Maker(seed, "cuda", torch.float32)
    n, d = PIPE_LAYERS, cfg.d_model
    return {"ln1": mk.make((d,), init="ones", stack=n),
            "ln2": mk.make((d,), init="ones", stack=n),
            "attn": layers.attn_init(mk, d, cfg.num_heads, cfg.num_kv_heads,
                                     cfg.resolved_head_dim, stack=n),
            "mlp": layers.gated_mlp_init(mk, d, cfg.d_ff, stack=n)}


def _pipe_inputs(cfg, seed: int):
    """(M, 1, 512, d) f32 hidden states from the seed, positions (1, 512)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    x = torch.randn((PIPE_MICRO, 1, PIPE_TOKENS, cfg.d_model),
                    generator=gen, device="cuda")
    return x, torch.arange(PIPE_TOKENS, device="cuda")[None]


def _digest_tensor(t) -> str:
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()


def _events_ms(fn) -> tuple:
    """(result, ms) of one call of ``fn`` on CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def _pipe_rank_runs(mesh, seed: int) -> dict:
    """One rank of the pipeline phase (see ``pipeline_phase``)."""
    cfg = lm_configs.get_config(LM_ARCH)
    line = mesh.line("pipe")
    s, idx = line.size, line.rank
    lo, hi = idx * PIPE_LAYERS // s, (idx + 1) * PIPE_LAYERS // s
    full = _pipe_layers(cfg, seed)
    x32, pos = _pipe_inputs(cfg, seed)
    mine32 = gpipe.stage_params(gpipe.split_stages(full, s), idx)

    def piped(stage, x, use_pallas):
        with torch.no_grad():
            return gpipe.gpipe_apply(
                stage, x, lambda p, h: transformer.run_layers(
                    cfg, p, h, pos, use_pallas=use_pallas), mesh=mesh)

    def sequential(tree, x, use_pallas):
        """Every microbatch through the 8 layers one after another, at
        the pipeline's shapes."""
        with torch.no_grad():
            return torch.stack([transformer.run_layers(
                cfg, tree, x[m], pos, use_pallas=use_pallas)
                for m in range(x.shape[0])])

    res = {"rank": idx, "layers": [lo, hi]}
    torch.cuda.reset_peak_memory_stats()
    # 1. bf16: the kernels' path pipelined, counted and timed; the plain
    # path; rank 0 runs both sequentially while the others wait
    x16 = x32.to(torch.bfloat16)
    mine16 = layers.cast_floats(mine32, torch.bfloat16)
    piped(mine16, x16, True)                       # warm-up
    line.barrier()
    ops.reset_launch_counts()
    out_k, res["piped_ms"] = _events_ms(lambda: piped(mine16, x16, True))
    res["launches"] = ops.launch_counts()["fused_swiglu"]
    out_p = piped(mine16, x16, False)
    res["plain_launches"] = ops.launch_counts()["fused_swiglu"] \
        - res["launches"]
    res["digest"] = _digest_tensor(out_k)
    line.barrier()
    if idx == 0:
        full16 = layers.cast_floats(full, torch.bfloat16)
        sequential(full16, x16[:1], True)          # warm-up
        seq_k, res["sequential_ms"] = _events_ms(
            lambda: sequential(full16, x16, True))
        seq_p = sequential(full16, x16, False)
        del full16
        res["bf16"] = {
            "piped_vs_sequential": _check_bf16(
                "pipeline bf16 kernels piped vs sequential", out_k, seq_k),
            "bit_equal": torch.equal(out_k, seq_k),
            "kernels_vs_plain": _check_bf16(
                "pipeline bf16 piped kernels vs plain", out_k, out_p),
            "sequential_kernels_vs_plain": _check_bf16(
                "pipeline bf16 sequential kernels vs plain", seq_k, seq_p),
            "plain_bit_equal": torch.equal(out_p, seq_p)}
        del seq_k, seq_p
    line.barrier()
    del out_k, out_p, mine16, x16
    # 2. the same in f32 (kernel 10's split-f32 path)
    ops.reset_launch_counts()
    out32 = piped(mine32, x32, True)
    res["f32_launches"] = ops.launch_counts()["fused_swiglu"]
    if idx == 0:
        seq32 = sequential(full, x32, True)
        err, tol = _check_close("pipeline f32 kernels piped vs sequential",
                                out32, seq32)
        res["f32"] = {"max_abs_err": err, "tolerance": tol,
                      "bit_equal": torch.equal(out32, seq32)}
        del seq32
    line.barrier()
    del out32
    # 3. gradients of sum(out ** 2), plain path in f32: this stage's
    # through the pipeline against the same layers' in the 8 run one
    # after another (per microbatch, the gradients summed)
    # (the stage's leaves are views of ``full``, made leaves that record
    # gradients: no copy)
    stage = _tree_map(lambda t: t.requires_grad_(), mine32)
    out = gpipe.gpipe_apply(
        stage, x32, lambda p, h: transformer.run_layers(cfg, p, h, pos),
        mesh=mesh)
    (out.float() ** 2).sum().backward()
    del out
    g_pipe = [t.grad for t in leaves(stage)]
    for t in leaves(stage):
        t.grad = None
    before = _tree_map(lambda t: t[:lo], full)
    after = _tree_map(lambda t: t[hi:], full)
    for m in range(PIPE_MICRO):
        with torch.no_grad():
            h = transformer.run_layers(cfg, before, x32[m], pos)
        h = transformer.run_layers(cfg, stage, h, pos)
        h = transformer.run_layers(cfg, after, h, pos)
        (h.float() ** 2).sum().backward()
    g_seq = [t.grad for t in leaves(stage)]
    diff = global_norm([a - b for a, b in zip(g_pipe, g_seq)])
    norm = global_norm(g_seq)
    dot = sum(float((a.double() * b.double()).sum())
              for a, b in zip(g_pipe, g_seq))
    cos = dot / (float(global_norm(g_pipe)) * float(norm))
    res["grad"] = {"rel_err": float(diff / norm), "cosine": cos,
                   "norm": float(norm),
                   "bit_equal": all(torch.equal(a, b)
                                    for a, b in zip(g_pipe, g_seq))}
    if not (res["grad"]["rel_err"] <= 1e-4 and cos >= 0.999999):
        raise RuntimeError(f"pipeline rank {idx}: stage gradients "
                           f"{res['grad']} against the sequential ones")
    del g_pipe, g_seq, stage
    # 4. the hop alone: one activation of 1 x 512 x d bf16 around the ring
    act = torch.zeros((1, PIPE_TOKENS, cfg.d_model), dtype=torch.bfloat16,
                      device="cuda")
    line.barrier()
    times = []
    for _ in range(PIPE_HOPS):
        t0 = time.perf_counter()
        gpipe.ring_shift(line, act)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res["hop"] = {"bytes": act.numel() * act.element_size(),
                  "ms": statistics.median(times), "backend": line.backend}
    res["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return res


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _pipe_rank(rank: int, init_method: str, seed: int, results) -> None:
    """A spawned rank of the pipeline phase: cuda:0 over gloo (NCCL
    refuses two ranks on one device), its results or its traceback to
    ``results``."""
    try:
        _precision_flags()
        build.load_libraries()
        init_data_mesh("cuda:0", rank=rank, world_size=PIPE_RANKS,
                       init_method=init_method, backend="gloo")
        try:
            mesh = make_host_mesh((1, PIPE_RANKS), ("data", "pipe"),
                                  device="cuda:0")
            res = _pipe_rank_runs(mesh, seed)
        finally:
            dist.destroy_process_group()
        results.put((rank, res))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def pipeline_phase(seed: int, root: Path) -> tuple[dict, list]:
    """GPipe (``distributed.pipeline.gpipe_apply``) over ``PIPE_RANKS``
    spawned processes sharing the card over gloo, on a (1, 4) ("data",
    "pipe") ``launch.mesh.make_host_mesh``: llama3-8b's layers at full
    width (d 4096, 32 heads, 8 KV heads, F 14336), 8 of 32 drawn from the
    seed, 2 a stage, ``PIPE_MICRO`` microbatches of 1 x 512.  1. bf16, the
    kernels' path (every stage's MLP on kernel 10, M 512) pipelined
    against the same 8 layers run one after another in rank 0 (§4's bound:
    3e-2 * max(1, max|p|), cosine 0.999; bit equality reported), the
    kernels' path against the plain path (§4); kernel 10 launched exactly
    M * L / S = 16 times a rank (fill and drain steps run no stage), 0 on
    the plain path; every rank's outputs equal (sha256).  2. the same in
    f32 at 1e-4 * max(1, max|p|).  3. each stage's gradients of sum(out **
    2) on the plain path in f32 against the sequential gradients of its
    layers: within 1e-4 relative global norm, cosine 0.999999.  4. the
    hop's bytes and host ms, peak MiB a rank.  Four processes time-share
    one card, so the pipelined forward cannot be faster than the
    sequential one; its ms is reported beside ``bubble_fraction``.
    Returns the ``{"pipeline"}`` row and kernel 10's row at M 512."""
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_pipe_rank, args=(
        r, f"file://{root}/gloo", seed, results))
        for r in range(PIPE_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    out: dict = {}
    try:
        while len(out) < PIPE_RANKS:
            rank, res = results.get(timeout=300)
            out[rank] = res
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    wall = time.perf_counter() - t0
    for rank, res in out.items():
        if isinstance(res, str):
            raise RuntimeError(f"pipeline rank {rank} failed:\n{res}")
    codes = [p.exitcode for p in procs]
    if codes != [0] * PIPE_RANKS:
        raise RuntimeError(f"pipeline ranks exited {codes}")
    ranks = [out[r] for r in range(PIPE_RANKS)]
    want = PIPE_MICRO * PIPE_LAYERS // PIPE_RANKS
    for r in ranks:
        if r["launches"] != want or r["f32_launches"] != want \
                or r["plain_launches"] != 0:
            raise RuntimeError(
                f"pipeline rank {r['rank']}: kernel 10 launched "
                f"{r['launches']} (bf16) / {r['f32_launches']} (f32) / "
                f"{r['plain_launches']} (plain) times, {want} / {want} / 0 "
                "expected")
    if len({r["digest"] for r in ranks}) != 1:
        raise RuntimeError("pipeline: the ranks' outputs differ")
    row = {
        "ranks": PIPE_RANKS, "layers": PIPE_LAYERS, "microbatches":
        PIPE_MICRO, "tokens": PIPE_TOKENS, "backend": ranks[0]["hop"]
        ["backend"], "wall_s": wall,
        "launches_per_rank": [r["launches"] for r in ranks],
        "launches_expected": want,
        "piped_ms": [r["piped_ms"] for r in ranks],
        "sequential_ms": ranks[0]["sequential_ms"],
        "bubble_fraction": gpipe.bubble_fraction(PIPE_RANKS, PIPE_MICRO),
        "bf16": ranks[0]["bf16"], "f32": ranks[0]["f32"],
        "grad": [r["grad"] for r in ranks],
        "hop": [r["hop"] for r in ranks],
        "peak_mib": [r["peak_mib"] for r in ranks],
        "note": "four processes time-share one card: no speed-up can show",
        "card_free_mib_before": free / 2**20,
        "parent_allocated_mib": torch.cuda.memory_allocated() / 2**20,
    }
    b = row["bf16"]
    print(f"pipeline: {PIPE_RANKS} ranks (gloo, one card), {PIPE_LAYERS} "
          f"llama3-8b layers, {PIPE_MICRO} x 1 x {PIPE_TOKENS}: bf16 piped "
          f"vs sequential max err {b['piped_vs_sequential'][0]:.3e} (tol "
          f"{b['piped_vs_sequential'][1]:.3e}, cos "
          f"{b['piped_vs_sequential'][2]:.6f}, bit-equal {b['bit_equal']}), "
          f"f32 {row['f32']['max_abs_err']:.3e} (bit-equal "
          f"{row['f32']['bit_equal']}), grads rel "
          f"{max(g['rel_err'] for g in row['grad']):.3e} / cos "
          f"{min(g['cosine'] for g in row['grad']):.8f}; kernel 10 "
          f"{row['launches_per_rank']} a rank ({want} expected); piped "
          f"{max(row['piped_ms']):.1f} ms vs sequential "
          f"{row['sequential_ms']:.1f} ms (bubble "
          f"{row['bubble_fraction']:.3f}; time-shared card); hop "
          f"{ranks[0]['hop']['bytes']} B in "
          f"{statistics.median(h['ms'] for h in row['hop']):.3f} ms; peak "
          f"{max(row['peak_mib']):.0f} MiB a rank", flush=True)
    cfg = lm_configs.get_config(LM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    w = tuple(_rand(gen, shape, torch.bfloat16, shape[0] ** -0.5)
              for shape in ((cfg.d_model, cfg.d_ff), (cfg.d_model, cfg.d_ff),
                            (cfg.d_ff, cfg.d_model)))
    cases = [swiglu_case(gen, f"swiglu_fwd pipeline stage M {PIPE_TOKENS}",
                         PIPE_TOKENS, w, "silu", torch.bfloat16, "pipeline")]
    rows = kernel_phase(cases)
    rows[0]["launches"] = sum(row["launches_per_rank"])
    rows[0]["on_main_path"] = True
    del cases, w
    return row, rows


# ---------------------------------------------------------------------------
# the launch phase: build_cell's steps, the roofline, the dry run
# ---------------------------------------------------------------------------

# llama3-8b at full width cut to 2 layers; batch cut, SHAPES' sequences
LAUNCH_LAYERS = 2
LAUNCH_BATCH = {"train_4k": 1, "prefill_32k": 1, "decode_32k": 8}
LAUNCH_DECODE_STEPS = 3


def _same_meta(name: str, real, meta) -> None:
    """``real`` (tensors on the card) has the shapes and dtypes of the
    ``meta`` structure ``build_cell`` gave."""
    if isinstance(meta, dict):
        for k in meta:
            _same_meta(f"{name}.{k}", real[k], meta[k])
        return
    if isinstance(real, int):
        if meta.shape != () or meta.dtype != torch.int32:
            raise RuntimeError(f"{name}: an int for {meta}")
        return
    if tuple(real.shape) != tuple(meta.shape) or real.dtype != meta.dtype:
        raise RuntimeError(f"{name}: {tuple(real.shape)} {real.dtype} "
                           f"against {tuple(meta.shape)} {meta.dtype}")


def _cell_terms(cfg, shape, accum: int, ms: float) -> dict:
    """The roofline's compute and memory terms of a cut cell at one chip
    (chips = model_par = dp_total = 1; no collective at one chip) beside
    the measured ms."""
    t = roofline.roofline_terms(cfg, shape, chips=1, model_par=1,
                                dp_total=1, accum=accum)
    comp, mem = t["compute"] * 1e3, t["memory"] * 1e3
    row = {"compute_ms": comp, "memory_ms": mem, "collective_ms": None,
           "collective_note": "left out at one chip",
           "larger": "compute" if comp >= mem else "memory",
           "share_of_larger": max(comp, mem) / ms}
    if shape.kind == "train":
        # the port recomputes nothing: its step does 3x the forward
        noremat = roofline.analytic_flops(cfg, shape)["flops_noremat"]
        row["compute_noremat_ms"] = noremat / roofline.PEAK_FLOPS * 1e3
    return row


def launch_cells(cfg, seed: int) -> tuple[dict, list]:
    """``build_cell``'s train, prefill and decode steps of llama3-8b at
    full width cut to ``LAUNCH_LAYERS`` layers, batches cut as
    ``LAUNCH_BATCH``, at SHAPES' sequence lengths on a one-chip mesh."""
    mesh = LogicalMesh((1, 1), ("data", "model"))
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    out, mlp_weights = {}, None

    # train_4k: f32 masters, the default accum (clamped to the batch)
    name = "train_4k"
    shape = dataclasses.replace(SHAPES[name], batch=LAUNCH_BATCH[name])
    step, args, _, donate, _ = build_cell(cfg, shape, mesh, multi_pod=False)
    params = transformer.decoder_init(cfg, seed, device="cuda")
    opt = adam_init(params)
    batch = _lm_batch(cfg, gen, shape.batch, shape.seq)
    batch = tuple(t.to(torch.int32) for t in batch)
    _same_meta(f"{name} params", params, args[0])
    _same_meta(f"{name} opt", {"mu": opt["mu"], "nu": opt["nu"]},
               {"mu": args[1]["mu"], "nu": args[1]["nu"]})
    for i, t in enumerate(batch):
        _same_meta(f"{name} input {i}", t, args[2 + i])
    losses = []
    params, opt, loss = step(params, opt, *batch)      # warm-up
    losses.append(loss.item())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        (params, opt, loss), ms = _events_ms(lambda: step(params, opt,
                                                          *batch))
        losses.append(loss.item())
        times.append(ms)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"launch {name}: losses {losses}")
    ms = statistics.median(times)
    out[name] = {"batch": shape.batch, "seq": shape.seq,
                 "accum_steps": step.accum_steps, "donate": list(donate),
                 "losses": losses, "ms": ms,
                 "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                 **_cell_terms(cfg, shape, step.accum_steps, ms)}
    del params, opt, batch, step
    torch.cuda.empty_cache()

    # prefill_32k and decode_32k: bf16 weights, kernel 10 on the MLPs
    params = transformer.decoder_init(cfg, seed, device="cuda",
                                      dtype=torch.bfloat16)
    mlp_weights = tuple(params["layers"]["mlp"][k][0]
                        for k in ("wg", "wu", "wd"))
    name = "prefill_32k"
    shape = dataclasses.replace(SHAPES[name], batch=LAUNCH_BATCH[name])
    steps = {k: build_cell(cfg, shape, mesh, multi_pod=False,
                           use_pallas=k)[0] for k in (True, False)}
    args = build_cell(cfg, shape, mesh, multi_pod=False)[1]
    tokens = torch.randint(0, cfg.vocab_size, (shape.batch, shape.seq),
                           generator=gen, device="cuda", dtype=torch.int32)
    pos = torch.arange(shape.seq, device="cuda",
                       dtype=torch.int32).expand(shape.batch, shape.seq)
    _same_meta(f"{name} params", params, args[0])
    _same_meta(f"{name} tokens", tokens, args[1])
    _same_meta(f"{name} positions", pos, args[2])
    steps[True](params, tokens, pos)                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    (tok_k, cache_k), ms = _events_ms(lambda: steps[True](params, tokens,
                                                          pos))
    launches = ops.launch_counts()["fused_swiglu"]
    peak = torch.cuda.max_memory_allocated() / 2**20
    ms2 = _events_ms(lambda: steps[True](params, tokens, pos))[1]
    ms = min(ms, ms2)
    if launches != cfg.num_layers:
        raise RuntimeError(f"launch {name}: kernel 10 launched {launches} "
                           f"times, {cfg.num_layers} expected")
    tok_p, cache_p = steps[False](params, tokens, pos)
    out[name] = {"batch": shape.batch, "seq": shape.seq, "ms": ms,
                 "peak_mib": peak, "launches": launches,
                 "kernels_vs_plain": {
                     k: _check_bf16(f"launch {name} cache {k} kernels vs "
                                    "plain", cache_k[k], cache_p[k])
                     for k in ("k", "v")},
                 "token_agreement": float((tok_k == tok_p).float().mean()),
                 **_cell_terms(cfg, shape, 1, ms)}
    # the logits behind the greedy token, both paths
    lg = {k: transformer.prefill(cfg, params, tokens, pos, shape.seq,
                                 use_pallas=k)[0] for k in (True, False)}
    out[name]["logits_kernels_vs_plain"] = _check_bf16(
        f"launch {name} logits kernels vs plain", lg[True], lg[False])
    if not torch.equal(lg[True][:, -1].argmax(-1).to(tok_k.dtype), tok_k):
        raise RuntimeError(f"launch {name}: the step's token is not the "
                           "argmax of its logits")
    del cache_k, cache_p, lg, tok_k, tok_p, tokens, pos
    torch.cuda.empty_cache()

    name = "decode_32k"
    shape = dataclasses.replace(SHAPES[name], batch=LAUNCH_BATCH[name])
    steps = {k: build_cell(cfg, shape, mesh, multi_pod=False,
                           use_pallas=k)[0] for k in (True, False)}
    args = build_cell(cfg, shape, mesh, multi_pod=False)[1]
    # a full 32,768-position cache of seeded values, the last
    # LAUNCH_DECODE_STEPS + 1 positions still free
    start = shape.seq - LAUNCH_DECODE_STEPS - 1
    state = {k: torch.randn(args[2][k].shape, generator=gen,
                            device="cuda").to(args[2][k].dtype)
             for k in ("k", "v")}
    state["pos"] = start
    _same_meta(f"{name} state", state, args[2])
    tokens = torch.randint(0, cfg.vocab_size, (shape.batch, 1),
                           generator=gen, device="cuda", dtype=torch.int32)
    _same_meta(f"{name} tokens", tokens, args[1])

    def at(p):
        return torch.full((shape.batch, 1), p, device="cuda",
                          dtype=torch.int32)

    _, state = steps[True](params, tokens, state, at(start))   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    times = []
    for _ in range(LAUNCH_DECODE_STEPS - 1):
        p = state["pos"]
        (tok, state), ms = _events_ms(
            lambda: steps[True](params, tokens, state, at(p)))
        times.append(ms)
    launches = ops.launch_counts()["fused_swiglu"]
    want = cfg.num_layers * (LAUNCH_DECODE_STEPS - 1)
    if launches != want:
        raise RuntimeError(f"launch {name}: kernel 10 launched {launches} "
                           f"times, {want} expected")
    p = state["pos"]
    lg = {}
    for k in (True, False):
        logits, new = transformer.decode_step(cfg, params, tokens, state,
                                              at(p), use_pallas=k)
        lg[k] = (logits, new["k"][:, :, p].clone(),
                 new["v"][:, :, p].clone())
    tok_k, _ = steps[True](params, tokens, dict(state), at(p))
    ms = statistics.median(times)
    out[name] = {"batch": shape.batch, "cache_positions": shape.seq,
                 "start_pos": start, "ms": ms,
                 "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                 "launches": launches,
                 "logits_kernels_vs_plain": _check_bf16(
                     f"launch {name} logits kernels vs plain", lg[True][0],
                     lg[False][0]),
                 "new_kv_kernels_vs_plain": [_check_bf16(
                     f"launch {name} new {n} kernels vs plain", lg[True][i],
                     lg[False][i]) for i, n in ((1, "k"), (2, "v"))],
                 **_cell_terms(cfg, shape, 1, ms)}
    if not torch.equal(lg[True][0].argmax(-1).to(tok_k.dtype), tok_k):
        raise RuntimeError(f"launch {name}: the step's token is not the "
                           "argmax of its logits")
    del state, lg, steps
    torch.cuda.empty_cache()
    return out, mlp_weights


def chgnet_cell_step(ds, seed: int, record: dict) -> dict:
    """The dry run's CHGNet cell at one rank: ``FAST_FS_HEAD``, one step
    on 8 crystals packed at JAX's per-device capacities (64 / 1,536 /
    2,048 atoms / bonds / angles a crystal), its peak MiB beside the
    record's argument bytes a rank."""
    per = 8
    caps = BatchCapacities(atoms=64 * per, bonds=1536 * per,
                           angles=2048 * per)
    idx = np.random.default_rng(seed + 8).permutation(len(ds))[:per]
    batch = build_device_batch(ds, idx, caps, num_crystal_slots=per)
    cfg = chgnet_mptrj.FAST_FS_HEAD
    tr = Trainer(cfg, TrainConfig(global_batch=per, total_steps=10,
                                  loss=chgnet_mptrj.LOSS), seed=seed,
                 device="cuda")
    tr.train(iter([batch]))                             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    hist, ms = _events_ms(lambda: tr.train(iter([batch])))
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise RuntimeError(f"chgnet cell: loss {hist}")
    row = {"crystals": per, "capacities": vars(caps), "ms": ms,
           "loss": hist[-1]["loss"],
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "resident_mib": base / 2**20,
           "record_argument_mib": record["memory"]["argument_bytes"] / 2**20,
           "real": {"atoms": int(batch.atom_mask.sum()),
                    "bonds": int(batch.bond_offsets[-1]),
                    "angles": int(batch.angle_offsets[-1])}}
    del tr
    return row


def launch_phase(ds, seed: int, root: Path) -> tuple[dict, list]:
    """1. ``build_cell``'s three step kinds on llama3-8b at full width cut
    to 2 layers (``launch_cells``): train_4k at batch 1 (f32 masters, the
    default accum), prefill_32k at batch 1 and decode_32k at batch 8
    against a 32,768-position cache (bf16, kernel 10), each timed on CUDA
    events with peak MiB, beside the roofline's compute and memory terms
    of the same cut cell at one chip and the measured share of the
    larger; 2. prefill and decode on the kernels' path against the plain
    path at §4's bound; 3. the dry run ``--all`` (records by status),
    ``torch.cuda.memory_allocated()`` unchanged; 4. the CHGNet cell's step
    at one rank.  Returns the ``{"launch"}`` row and kernel 10's rows at
    the prefill and decode shapes."""
    torch.cuda.empty_cache()
    cfg = lm_configs.get_config(LM_ARCH).with_(num_layers=LAUNCH_LAYERS)
    cells, mlp = launch_cells(cfg, seed)
    for name, c in cells.items():
        print(f"launch {name}: batch {c['batch']}, {c['ms']:.1f} ms, peak "
              f"{c['peak_mib']:.0f} MiB; roofline compute "
              f"{c['compute_ms']:.2f} ms, memory {c['memory_ms']:.2f} ms "
              f"({c['larger']} larger: {c['share_of_larger']:.3f} of the "
              "measured time)", flush=True)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = dryrun.main(["--all", "--out", str(root / "dryrun.json")])
    dry_s = time.perf_counter() - t0
    after = torch.cuda.memory_allocated()
    if after != before:
        raise RuntimeError("the dry run allocated on the card")
    with open(root / "dryrun.json") as f:
        recs = json.load(f)
    by_status = {}
    for r in recs:
        key = r["status"].split(":")[0]
        by_status[key] = by_status.get(key, 0) + 1
    if rc != 0 or len(recs) != 2 * 40 + 2 or by_status != {"ok": 66,
                                                           "skip": 16}:
        raise RuntimeError(f"dry run: rc {rc}, {len(recs)} records, "
                           f"{by_status}")
    chg = [r for r in recs if r["arch"] == dryrun.CHGNET_ARCH
           and r["mesh"] == "16x16"][0]
    chgnet_row = chgnet_cell_step(ds, seed, chg)
    llama = [r for r in recs if r["arch"] == LM_ARCH and r["status"] == "ok"]
    row = {"cells": cells, "layers": LAUNCH_LAYERS,
           "dryrun": {"records": len(recs), "by_status": by_status,
                      "seconds": dry_s, "allocated_before": before,
                      "allocated_after": after,
                      "llama3-8b": {f"{r['shape']} {r['mesh']}": {
                          "argument_gib": r["memory"]["argument_bytes"]
                          / 2**30, "fits_80gb": r["fits_80gb"]}
                          for r in llama}},
           "chgnet_cell": chgnet_row}
    print(f"launch dry run: {len(recs)} records {by_status} in {dry_s:.2f} "
          f"s, no allocation on the card; chgnet cell step "
          f"{chgnet_row['ms']:.1f} ms, peak {chgnet_row['peak_mib']:.0f} MiB "
          f"(record's arguments {chgnet_row['record_argument_mib']:.1f} MiB a"
          " rank)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    m_prefill = LAUNCH_BATCH["prefill_32k"] * SHAPES["prefill_32k"].seq
    m_decode = LAUNCH_BATCH["decode_32k"]
    cases = [swiglu_case(gen, f"swiglu_fwd launch prefill_32k M {m_prefill}",
                         m_prefill, mlp, "silu", torch.bfloat16,
                         "prefill_32k"),
             swiglu_case(gen, f"swiglu_fwd launch decode_32k M {m_decode}",
                         m_decode, mlp, "silu", torch.bfloat16,
                         "decode_32k")]
    rows = kernel_phase(cases)
    rows[0]["launches"] = cells["prefill_32k"]["launches"]
    rows[1]["launches"] = cells["decode_32k"]["launches"]
    for r in rows:
        r["on_main_path"] = True
    del cases, mlp
    torch.cuda.empty_cache()
    return row, rows



def _stamp(t_start: float, phase: str) -> None:
    print(f"chip_smoke: {phase} done at {time.perf_counter() - t_start:.1f}"
          " s", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR",
                    help="also trace one MD step and one training step per "
                         "config with torch.profiler and write their "
                         "per-kernel device times to DIR")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this run needs a GPU")
    t_start = time.perf_counter()
    _precision_flags()

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    print(smi.splitlines()[0], flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.load_libraries()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for lib in ("swiglu", "flash_attention", "gated_mlp", "message_passing",
                "message_passing_bf16", "message_passing_bwd", "segment_sum",
                "basis"):
        log = build.build_log(lib)
        print(f"{lib}.cu: {log.splitlines()[0]}", flush=True)
        for line in ptxas_lines(log):
            print(f"ptxas {lib}.cu {line}", flush=True)

    # serving set-up: 16-64-atom synthetic crystals; full-width parameters
    # from the seed (FAST_FUSED and FAST_PALLAS share one tree)
    cfg = chgnet_mptrj.FAST_FUSED
    params = chgnet.chgnet_init(args.seed, cfg)
    syn = SyntheticConfig(min_atoms=16, max_atoms=64,
                          lognormal_mu=math.log(40.0), lognormal_sigma=0.4)
    rng = np.random.default_rng(args.seed)
    crystals = [generate_crystal(rng, syn) for _ in range(REPLICAS)]
    t0 = time.perf_counter()
    serve = ServeEngine.for_structures(params, cfg, crystals, device="cuda")
    md = BatchedMD(serve, crystals)
    print(f"set-up: {len(crystals)} replicas of "
          f"{min(c.num_atoms for c in crystals)}-"
          f"{max(c.num_atoms for c in crystals)} atoms, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # the batches the first MD step packs, one per group
    graphs = [build_graph(c, cfg.r_cut_atom, cfg.r_cut_bond)
              for c in crystals]
    probe = []
    for bucket, ids in md.groups(graphs):
        slots = _slots(len(ids))
        b = batch_crystals([crystals[i] for i in ids],
                           [graphs[i] for i in ids], bucket.scaled(slots),
                           num_crystal_slots=slots)
        probe.append(b.to("cuda"))
    group_sizes = [{"atoms": int(b.atom_mask.sum()),
                    "bonds": int(b.bond_offsets[-1]),
                    "angles": int(b.angle_offsets[-1]),
                    "atom_cap": b.atom_cap, "bond_cap": b.bond_cap,
                    "angle_cap": b.angle_cap} for b in probe]
    print(f"groups: {group_sizes}", flush=True)

    # training set-up: the JAX package's default synthetic dataset (256
    # crystals of 2-64 atoms, seed 0), capacities for batches of 128
    t0 = time.perf_counter()
    ds = make_dataset(SyntheticConfig())
    train_caps = capacity_for(ds, TRAIN_BATCH)
    train_ladder = ladder_for(ds, TRAIN_BATCH)
    train_b0 = next(iter(BatchIterator(ds, TRAIN_BATCH, 1, train_caps,
                                       seed=args.seed))).to("cuda")
    print(f"dataset: {len(ds)} crystals, {time.perf_counter() - t0:.2f} s; "
          f"capacities {train_caps}; ladder {train_ladder.buckets}",
          flush=True)

    # 3. kernels, on the first training batch and on the largest serving
    # group's batch
    big = max(range(len(probe)), key=lambda i: group_sizes[i]["bonds"])
    tree = serve.model.tree()
    train_cases = kernel_cases(tree, cfg, train_b0)
    tier_cases = tier_kernel_cases(tree, cfg, train_b0)
    sym_cases = sym_kernel_cases(tree, train_b0)
    rows = kernel_phase(train_cases)
    tier_rows = kernel_phase(tier_cases)
    sym_rows = kernel_phase(sym_cases)
    # the bf16 paths of kernels 1-7 (the mixed tiers); their bf16 and f32
    # copies of the batch's tables are freed at once (the train phases'
    # peak memory must not hold them)
    bf16_train_cases = bf16_cases(train_cases + tier_cases + sym_cases)
    bf16_rows = kernel_phase(bf16_train_cases)
    bf16_train_paths = [(c["path"], c["primary"]) for c in bf16_train_cases]
    del bf16_train_cases
    for c in tier_cases:  # their bf16 copies
        c.pop("bf16_args", None)
        c.pop("bf16_library", None)
    serve_cases = kernel_cases(tree, cfg, probe[big])
    serve_kernel_rows = kernel_phase(serve_cases)
    serve_tier_cases = tier_kernel_cases(tree, cfg, probe[big])
    serve_tier_rows = kernel_phase(serve_tier_cases)
    serve_sym_cases = sym_kernel_cases(tree, probe[big])
    serve_sym_rows = kernel_phase(serve_sym_cases)
    bf16_serve_cases = bf16_cases(serve_cases + serve_tier_cases
                                  + serve_sym_cases)
    serve_bf16_rows = kernel_phase(bf16_serve_cases)
    bf16_serve_paths = [c["path"] for c in bf16_serve_cases]
    conv_bwd_rows = conv_backward_rows(serve_cases + serve_sym_cases, "serve")
    del bf16_serve_cases, serve_cases, serve_tier_cases
    print(f"kernels: {edge_case_phase(tree, args.seed)} ragged-layout and "
          "edge cases agree with the plain versions", flush=True)

    _stamp(t_start, "kernels and edge cases")
    # 4. the wrappers' backwards against plain autograd, on the training
    # batch
    backward_rows = backward_phase(
        train_cases + tier_cases + sym_backward_cases(sym_cases), args.seed)
    conv_bwd_rows += conv_backward_rows(train_cases + sym_cases, "train")

    _stamp(t_start, "backwards")
    # 5. serve: each path driven with the counters set to 0 just before it
    serve_rows = {
        "FAST_FUSED": serve_phase("FAST_FUSED", cfg, params, crystals, probe,
                                  STEPS, PER_FORWARD, args.profile),
        "FAST_PALLAS": serve_phase("FAST_PALLAS", FAST_PALLAS, params,
                                   crystals, probe, STEPS,
                                   PER_FORWARD_PALLAS, args.profile),
        "WO_HEAD_PALLAS": serve_phase(
            "WO_HEAD_PALLAS", WO_HEAD_PALLAS,
            chgnet.chgnet_init(args.seed, WO_HEAD_PALLAS), crystals, probe,
            2, PER_FORWARD_WO_HEAD),
        "FAST_FUSED_SYM": serve_phase(
            "FAST_FUSED_SYM", chgnet_mptrj.FAST_FUSED_SYM, params, crystals,
            probe, STEPS, PER_FORWARD_SYM, args.profile),
        "FAST_FUSED_HALF": serve_phase(
            "FAST_FUSED_HALF", chgnet_mptrj.FAST_FUSED_HALF, params,
            crystals, probe, 2, PER_FORWARD),
        # the mixed tiers on the f32 parameters (bf16 operands, f32 sums
        # and outputs), against their plain paths and their f32 configs
        "FAST_FUSED_MIXED": serve_phase(
            "FAST_FUSED_MIXED", chgnet_mptrj.FAST_FUSED_MIXED, params,
            crystals, probe, STEPS, PER_FORWARD, args.profile,
            reference=cfg),
        "FAST_FUSED_HALF_MIXED": serve_phase(
            "FAST_FUSED_HALF_MIXED", chgnet_mptrj.FAST_FUSED_HALF_MIXED,
            params, crystals, probe, 2, PER_FORWARD,
            reference=chgnet_mptrj.FAST_FUSED_HALF),
        # the tiers whose kernels 1 and 7, 5 and 6, 4b run in bf16
        "FAST_PALLAS_MIXED": serve_phase(
            "FAST_PALLAS_MIXED", FAST_PALLAS_MIXED, params, crystals, probe,
            2, PER_FORWARD_PALLAS, reference=FAST_PALLAS),
        "FAST_FUSED_SYM_MIXED": serve_phase(
            "FAST_FUSED_SYM_MIXED", FAST_FUSED_SYM_MIXED, params, crystals,
            probe, 2, PER_FORWARD_SYM,
            reference=chgnet_mptrj.FAST_FUSED_SYM),
        "FAST_FUSED_VIRIAL_MIXED": serve_phase(
            "FAST_FUSED_VIRIAL_MIXED", FAST_FUSED_VIRIAL_MIXED, params,
            crystals, probe, 2, PER_FORWARD_VIRIAL,
            reference=chgnet_mptrj.FAST_FUSED_VIRIAL),
    }
    for row in serve_kernel_rows:
        row["launches"] = serve_rows["FAST_FUSED"]["launches"][row["wrapper"]]
    for row in serve_tier_rows:
        row["launches"] = serve_rows["FAST_PALLAS"]["launches"][row["wrapper"]]
    for row, c in zip(serve_sym_rows, serve_sym_cases):
        row["launches"] = serve_rows[c["path"]]["launches"][row["wrapper"]]
    for row, path in zip(serve_bf16_rows, bf16_serve_paths):
        row["launches"] = serve_rows[path]["launches"][row["wrapper"]]
    serve_rows["FAST_FUSED"]["groups"] = group_sizes
    serve_rows["kernels_at_serve_batch"] = serve_kernel_rows \
        + serve_tier_rows + serve_sym_rows + serve_bf16_rows
    print(json.dumps({"serve": serve_rows}))

    _stamp(t_start, "serve")
    # 6. the fused convs beside the unfused tier's GatedMLP and bases
    fused_mlp = fused_mlp_pallas_phase(args.seed, train_b0)
    # the undirected store against the directed one: the same function
    half_vs_fused = half_equals_fused_phase(args.seed, train_b0)

    # 7. train: each path driven with the counters set to 0 just before it;
    # at capacity_for, and beside FAST_FUSED and FAST_FUSED_SYM the same
    # on the ladder, fed synchronously ("ladder") and through the
    # Prefetcher ("prefetch")
    train_rows = {}
    # kernels whose device time in a training step is printed from a trace
    traced = {"FAST_FUSED_VIRIAL": ("crystal_row_sum_kernel",
                                    "force_split_kernel"),
              "FAST_PALLAS": ("rbf_kernel", "fourier_kernel",
                              "gated_mlp_split_kernel", "segment_sum_kernel"),
              # the three tiers' bf16 kernels (the same names: templates)
              "FAST_PALLAS_MIXED": ("gated_mlp_split_kernel",
                                    "segment_sum_kernel"),
              "FAST_FUSED_SYM_MIXED": ("conv_split_kernel",
                                       "segment_sum_kernel"),
              "FAST_FUSED_VIRIAL_MIXED": ("crystal_row_sum_kernel",
                                          "force_split_kernel")}
    # operators whose device time in a training step is printed: the
    # gathers' backward over the padded rows
    padded = ("embedding_dense_backward",)
    fused, sym = chgnet_mptrj.FAST_FUSED, chgnet_mptrj.FAST_FUSED_SYM
    mixed = chgnet_mptrj.FAST_FUSED_MIXED
    # the new mixed tiers, each also held to its f32 config on the first
    # batch
    f32_configs = {"FAST_PALLAS_MIXED": FAST_PALLAS,
                   "FAST_FUSED_SYM_MIXED": sym,
                   "FAST_FUSED_VIRIAL_MIXED": chgnet_mptrj.FAST_FUSED_VIRIAL}
    traced["FAST_FUSED_MIXED prefetch"] = ("conv_split_kernel",
                                           "force_split_kernel")
    for name, tcfg, caps, steps, per, prefetch in (
            ("FAST_FUSED", fused, train_caps, 5, PER_FORWARD, False),
            ("FAST_FUSED ladder", fused, train_ladder, 3, PER_FORWARD,
             False),
            ("FAST_FUSED prefetch", fused, train_ladder, 5, PER_FORWARD,
             True),
            ("FAST_FUSED_VIRIAL", chgnet_mptrj.FAST_FUSED_VIRIAL,
             train_caps, 3, PER_FORWARD_VIRIAL, False),
            ("FAST_PALLAS", FAST_PALLAS, train_caps, 3, PER_FORWARD_PALLAS,
             False),
            ("WO_HEAD_PALLAS", WO_HEAD_PALLAS, train_caps, 2,
             PER_FORWARD_WO_HEAD, False),
            ("FAST_FUSED_SYM", sym, train_caps, 3, PER_FORWARD_SYM, False),
            ("FAST_FUSED_SYM prefetch", sym, train_ladder, 5,
             PER_FORWARD_SYM, True),
            ("FAST_FUSED_HALF", chgnet_mptrj.FAST_FUSED_HALF, train_caps, 2,
             PER_FORWARD, False),
            ("FAST_FUSED_MIXED prefetch", mixed, train_ladder, 5,
             PER_FORWARD, True),
            ("FAST_FUSED_HALF_MIXED", chgnet_mptrj.FAST_FUSED_HALF_MIXED,
             train_caps, 2, PER_FORWARD, False),
            ("FAST_PALLAS_MIXED", FAST_PALLAS_MIXED, train_caps, 2,
             PER_FORWARD_PALLAS, False),
            ("FAST_FUSED_SYM_MIXED", FAST_FUSED_SYM_MIXED, train_caps, 2,
             PER_FORWARD_SYM, False),
            ("FAST_FUSED_VIRIAL_MIXED", FAST_FUSED_VIRIAL_MIXED, train_caps,
             2, PER_FORWARD_VIRIAL, False),
            ("REFERENCE", chgnet_mptrj.REFERENCE, train_caps, 2, {},
             False)):
        train_rows[name] = train_phase(
            name, tcfg, ds, caps, steps, per, args.seed, args.profile,
            traced.get(name, ()),
            padded if tcfg in (fused, sym, mixed) else (), prefetch,
            reference=f32_configs.get(name))
    for row in rows + tier_rows:
        path = {"fused_force_virial_readout": "FAST_FUSED_VIRIAL",
                "fused_segment_sum": "FAST_PALLAS",
                "fused_gated_mlp_packed": "FAST_PALLAS",
                "fused_rbf": "FAST_PALLAS", "fused_fourier": "FAST_PALLAS",
                }.get(row["wrapper"], "FAST_FUSED")
        row["launches"] = train_rows[path]["launches"][row["wrapper"]]
        if not row["launches"]:
            raise RuntimeError(f"{row['name']} was not launched on {path}")
    for row, c in zip(sym_rows, sym_cases):
        row["launches"] = train_rows[c["path"]]["launches"][row["wrapper"]]
        if not row["launches"]:
            raise RuntimeError(f"{row['name']} was not launched on "
                               f"{c['path']}")
    # the convs' backward kernel on the main path: the directed forms at
    # the training batch, with their launches on the FAST_FUSED steps
    bwd_rows = []
    for row in conv_bwd_rows:
        if row["batch"] != "train" or "[" in row["name"]:
            continue
        launches = train_rows["FAST_FUSED"]["bwd_launches"][row["wrapper"]]
        if not launches:
            raise RuntimeError(f"{row['name']} was not launched on "
                               "FAST_FUSED")
        bwd_rows.append({
            "name": f"conv_bwd_kernel {row['name']}", "route": "cuda",
            "source": f"{CSRC}/message_passing_bwd.cu",
            "replaces": "the chunked recompute (_recompute_vjp)",
            "wrapper": row["wrapper"], "max_rel_err": row["max_rel_err"],
            "tolerance": 1e-4, "ms": row["ms"],
            "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "launches": launches, "shape": row["shape"]})
    # the bf16 rows: directed convs and 4a on FAST_FUSED_MIXED (through
    # the prefetcher), [pair] on FAST_FUSED_HALF_MIXED, [pair+und], 5 and 6
    # on FAST_FUSED_SYM_MIXED, 4b on FAST_FUSED_VIRIAL_MIXED, 1 and 7 on
    # FAST_PALLAS_MIXED; the extra shapes of 1 and 7 beside the others
    bf16_path = {"FAST_FUSED_MIXED": "FAST_FUSED_MIXED prefetch"}
    bf16_on_path, bf16_extra = [], []
    for row, (case_path, primary) in zip(bf16_rows, bf16_train_paths):
        path = bf16_path.get(case_path, case_path)
        row["launches"] = train_rows[path]["launches"][row["wrapper"]]
        if not row["launches"]:
            raise RuntimeError(f"{row['name']} was not launched on {path}")
        (bf16_on_path if primary else bf16_extra).append(row)

    _stamp(t_start, "train")
    # 9. load-balanced training through StepPlans (DESIGN.md §6), beside
    # FAST_FUSED prefetch; 10. the runtime (DESIGN.md §8), its checkpoints
    # under build/ (git-ignored), removed after
    card = smi.splitlines()[0]
    balanced = balanced_phase(ds, train_ladder, train_caps, args.seed, card,
                              train_rows["FAST_FUSED prefetch"])
    _stamp(t_start, "balanced")
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_runtime"
    shutil.rmtree(root, ignore_errors=True)
    try:
        runtime = runtime_phase(ds, train_ladder, args.seed, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _stamp(t_start, "runtime")
    # 11. data parallelism: one rank over NCCL, then two processes sharing
    # the card over gloo (their rendezvous files under build/, removed)
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_dp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        dp = dp_phase(ds, train_ladder, args.seed, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"dp": dp}))
    _stamp(t_start, "dp")
    # 12. learns, in f32 and at the mixed tier
    learns = learns_phase(args.seed)
    learns_mixed = learns_phase(args.seed, mixed)
    primary = [r for r, c in zip(tier_rows, tier_cases) if c["primary"]]
    extra = [r for r, c in zip(tier_rows, tier_cases) if not c["primary"]]
    print(json.dumps({"train": dict(
        train_rows, FUSED_MLP_PALLAS=fused_mlp,
        FAST_FUSED_HALF_vs_FAST_FUSED=half_vs_fused, backward=backward_rows,
        conv_bwd=conv_bwd_rows,
        balanced=balanced, runtime=runtime,
        learns=learns, learns_mixed=learns_mixed,
        kernel_extra_shapes=extra + bf16_extra,
        dataset={"crystals": len(ds), "caps": vars(train_caps),
                 "ladder": [vars(b) for b in train_ladder.buckets]})}))
    _stamp(t_start, "learns")
    # 13. the LM: every CHGNet phase's state is gone; return its cache
    torch.cuda.empty_cache()
    lm_row, lm_kernel_rows = lm_phase(args.seed, args.profile)
    print(json.dumps({"lm": lm_row}))
    _stamp(t_start, "lm")
    # 14. one forward for eval metrics and serve outputs, on the largest
    # serving group's batch and the first training batch
    print(json.dumps({"eval_serve": eval_serve_phase(
        args.seed, {"serve": probe[big], "train": train_b0})}))
    _stamp(t_start, "eval_serve")
    # 15. LM training; 16. the MoE family; 17. qwen1.5-110b
    print(json.dumps({"lm_train": lm_train_phase(args.seed)}))
    _stamp(t_start, "lm_train")
    moe_row, moe_kernel_rows = moe_phase(args.seed)
    print(json.dumps({"moe": moe_row}))
    _stamp(t_start, "moe")
    qwen_row, qwen_kernel_rows = qwen110b_phase(args.seed)
    print(json.dumps({"qwen110b": qwen_row}))
    _stamp(t_start, "qwen110b")
    # 18. item 14d's families: qwen2-vl, zamba2, rwkv6, whisper
    families_row, families_kernel_rows = families_phase(args.seed)
    print(json.dumps({"families": families_row}))
    _stamp(t_start, "families")
    # 19. GPipe: llama3-8b's layers over 4 ranks sharing the card over
    # gloo (their rendezvous file under build/, removed)
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_pipe"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        pipe_row, pipe_kernel_rows = pipeline_phase(args.seed, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"pipeline": pipe_row}))
    _stamp(t_start, "pipeline")
    # 20. build_cell's steps, the roofline beside them, the dry run, the
    # CHGNet cell (the dry run's records under build/, removed)
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_launch"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        launch_row, launch_kernel_rows = launch_phase(ds, args.seed, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"launch": launch_row}))
    _stamp(t_start, "launch")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    print(json.dumps({"kernels": rows + primary + sym_rows + bwd_rows
                      + bf16_on_path
                      + lm_kernel_rows + moe_kernel_rows
                      + qwen_kernel_rows + families_kernel_rows
                      + pipe_kernel_rows + launch_kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
