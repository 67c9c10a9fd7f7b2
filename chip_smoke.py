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
     and the symmetric conv's two kernels; the bf16 paths of kernels 2, 3
     and 4a (each conv variant) on the same batches' values rounded to
     bf16, within one bf16 rounding (``2**-7 * max(1, max|plain|)``) of
     their bf16 plain versions, equal bits on two calls, bound at the bf16
     peak, their split-f32 kernels timed in turns beside them; then ragged
     layouts and edge
     values (for the convs: a row longer than a block's chunk, rows
     straddling tiles, no edge at all, a single row, D = 128; for the force
     readouts at every width: a 700-bond row, rows straddling tiles, a
     crystal with no bonds between two that have them, every row padded,
     crystal slots permuted and crystals interleaved; for phase A at every
     width: 0, 1 and 64 +- 1, 128 +- 1 real rows with self-image pairs;
     the convs and kernel 4a also in bf16;
     for the RBF and Fourier bases at K of 7, 31 and 127: 0, 1, 3, T +- 1
     and 4 T + 3 rows with zero rows amid them; each called twice for
     equal bits, the bases also on the batches' inputs), and batches with
     self-image pairs and singleton undirected entries;
  4. backward: the kernel wrappers' backwards (recompute, or a gather for
     the segment sum) against plain autograd through ``kernels.ref`` on
     the card, and whether two backward runs give bitwise equal gradients;
  5. serve: ``ServeEngine`` / ``BatchedMD`` with 16 replicas, one warm-up
     MD step then counted steps, at ``FAST_FUSED`` (5 steps), at
     ``FAST_PALLAS`` (the unfused Pallas tier: segment sum, GatedMLP, RBF
     and Fourier kernels; 5 steps) and at ``WO_HEAD_PALLAS`` (the same tier
     with the autodiff readout: forces and stress are derivatives of the
     energy through the wrappers' backwards; 2 steps), at
     ``FAST_FUSED_SYM`` (the symmetric half-graph trunk; 5 steps), at
     ``FAST_FUSED_HALF`` (the undirected store; 2 steps) and at the mixed
     tiers ``FAST_FUSED_MIXED`` (5 steps) and ``FAST_FUSED_HALF_MIXED`` (2
     steps: bf16 operands, f32 sums and outputs, on the f32 parameters);
     the launch counters must show every kernel of the path, the outputs
     must be finite, and one batch through the plain path must agree (the
     mixed tiers within DESIGN.md §4's bound, 3e-2 of the largest value
     and cosine 0.999, also against their f32 configs);
  6. ``FAST_FUSED`` with ``mlp_impl="pallas"``: one forward and backward on
     the first training batch against the plain path, with launch counts;
  7. train: ``Trainer`` over a ``BatchIterator`` of the synthetic dataset
     at batch 128, at ``FAST_FUSED`` (1 + 5 steps), ``FAST_FUSED_VIRIAL``
     (1 + 3), ``FAST_PALLAS`` (1 + 3), ``WO_HEAD_PALLAS`` (1 + 2: a double
     backward through the wrappers), ``FAST_FUSED_SYM`` (1 + 3),
     ``FAST_FUSED_HALF`` (1 + 2), ``FAST_FUSED_HALF_MIXED`` (1 + 2) and
     ``REFERENCE`` (1 + 2, no kernels: the paper's baseline), all at
     ``capacity_for``; beside them
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
     time of kernel 4b's two kernels (``FAST_FUSED_VIRIAL``), of the bases
     (``FAST_PALLAS``) and of ``embedding_dense_backward`` (the fused
     tiers, at both capacities);
  8. ``FAST_FUSED_HALF`` computes ``FAST_FUSED``'s function (DESIGN.md
     §5): on the first training batch and one parameter tree every output
     and the loss must agree;
  9. learns: 60 steps at batch 8 at ``FAST_FUSED``, and again at
     ``FAST_FUSED_MIXED``, must bring a held-out batch's loss below 0.6x
     its value before;
 10. lm: llama3-8b at full width and depth with bf16 weights from the
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
     against plain within 1e-4.

``FAST_PALLAS``, ``WO_HEAD_PALLAS`` and ``FUSED_MLP_PALLAS`` are labels of
this script for tiers that are no named config of the package.  bf16
products outside the kernels (cuBLAS) sum in f32
(``allow_bf16_reduced_precision_reduction`` off), as TF32 is off for f32
ones.  Prints
``{"serve": ...}``, ``{"train": ...}``, ``{"lm": ...}`` and ``{"kernels":
[...]}`` JSON lines and, last, ``{"ok": true, "device": {...}}``.  Any failure raises and
exits nonzero; without CUDA it exits nonzero before printing a result.

    python3 chip_smoke.py [--seed 0] [--profile DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

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
    BatchIterator,
    Prefetcher,
    SyntheticConfig,
    generate_crystal,
    make_dataset,
)
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.precision import resolve_policy, scale_loss  # noqa: E402
from repro_torch.serve import BatchedMD, ServeEngine  # noqa: E402
from repro_torch.serve import lm  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    TrainConfig,
    Trainer,
    apply_grads,
    chgnet_loss_fn,
    grads_of,
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

# kernel launches per forward, by wrapper; every other counter must stay 0
# (also FAST_FUSED_HALF and the mixed tiers FAST_FUSED_MIXED and
# FAST_FUSED_HALF_MIXED, whose launches are the bf16 kernels')
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


def plain_config(cfg):
    """The same function with no kernel: unfused convs, scatter sums and
    the packed GatedMLP in plain PyTorch."""
    return cfg.with_(conv_impl="unfused", agg_impl="scatter",
                     mlp_impl="packed" if cfg.mlp_impl == "pallas"
                     else cfg.mlp_impl)


def check_launches(name: str, counts: dict, per_forward: dict,
                   forwards: int) -> None:
    """Every wrapper launched ``per_forward`` times per forward, every other
    wrapper never."""
    for fn, n in counts.items():
        want = per_forward.get(fn, 0) * forwards
        if n != want:
            raise RuntimeError(f"{name}: {fn} launched {n} times in "
                               f"{forwards} forwards, expected {want}")


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


def _check_close(name: str, got, want) -> tuple[float, float]:
    """Max abs error of ``got`` against ``want`` and the tolerance it met,
    ``1e-4 * max(1, max|want|)``; raises if it did not.  Tuples are checked
    element by element and report the largest error and tolerance."""
    if isinstance(got, tuple):
        pairs = [_check_close(f"{name}[{i}]", g, w)
                 for i, (g, w) in enumerate(zip(got, want, strict=True))]
        return max(p[0] for p in pairs), max(p[1] for p in pairs)
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite values")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    tol = 1e-4 * max(1.0, want.abs().max().item() if want.numel() else 0.0)
    if not err <= tol:
        raise RuntimeError(f"{name}: max abs error {err} > {tol}")
    return err, tol


def _equal(a, b) -> bool:
    """Bitwise equality of two outputs, tensors or tuples of them."""
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b, strict=True))
    return torch.equal(a, b)


def _check_bf16(name: str, got, want) -> tuple[float, float, float]:
    """DESIGN.md §4's bound for bf16 outputs: max abs error within ``3e-2 *
    max(1, max|want|)`` and cosine similarity at least 0.999 (bf16 rounds
    at other places on the two sides); returns (error, tolerance, cosine)
    and raises if either fails."""
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite values")
    err = (got - want).abs().max().item()
    tol = 3e-2 * max(1.0, want.abs().max().item())
    cos = torch.nn.functional.cosine_similarity(
        got.flatten(), want.flatten(), dim=0).item()
    if not (err <= tol and cos >= 0.999):
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


def bf16_cases(cases) -> list[dict]:
    """The bf16 paths of kernels 2, 3 and 4a (``FAST_FUSED_MIXED``,
    ``FAST_FUSED_HALF_MIXED``) from their split-f32 cases on the same
    batch: every float operand rounded to bf16, held to the bf16 plain
    version within one bf16 rounding (``_check_round_bf16``) and called
    twice for equal bits; bound by the flops at the bf16 peak and the
    bytes with bf16 tables (int32 ids); the split-f32 kernel on the same
    values in f32 timed in turns beside it (``f32_ms``, ``f32_device_ms``).
    Kernel 4a's wrapper widens x_hat to f32 inside the timed call."""
    out = []
    for c in cases:
        if c.get("counter", c["wrapper"].__name__) not in (
                "fused_atom_conv", "fused_bond_conv", "fused_force_readout"):
            continue
        args = _to_bf16(c["args"])
        twin_args = _to_f32(args)
        base, _, variant = c["name"].partition("[")
        name = base.replace("_fwd", "_bf16_fwd") + (f"[{variant}"
                                                    if variant else "")
        wrapper = c["wrapper"]
        # the partition is the f32 plan's; the stages take half the bytes
        bf = ops.conv_plan("force" if "force" in name else name[:4],
                           c["shape"]["dim"], 1 << 30, torch.cuda
                           .get_device_properties(0).multi_processor_count,
                           itemsize=2)
        out.append(dict(
            name=name, counter=c.get("counter", wrapper.__name__),
            path=c.get("path", "FAST_FUSED") + "_MIXED", wrapper=wrapper,
            plain=c["plain"], args=args, check=_check_round_bf16,
            repeat=True, peak=PEAK_BF16_FLOPS,
            twin=lambda w=wrapper, a=twin_args: w(*a),
            replaces=c["replaces"], flops=c["flops"],
            bytes=2 * c["float_elems"] + 4 * c["int_elems"],
            plan=dict(c["plan"], smem=bf.smem,
                      blocks_per_sm=bf.blocks_per_sm),
            shape=c["shape"]))
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


def sym_plan_row(dim: int, n_real: int, n_rows: int) -> dict:
    """The launch plan of kernel 5 on this card (``ops.conv_plan("sym")``)
    and how its blocks stride over this batch's real rows."""
    plan = ops.conv_plan("sym", dim, n_rows, torch.cuda.get_device_properties(
        0).multi_processor_count)
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
        # + per bond: n*d and 9 products of 2 factors; + the crystal sum
        dict(name="force_virial_fwd", wrapper=ops.fused_force_virial_readout,
             plain=ref.fused_force_virial_readout_ref,
             args=(e, x_hat, dist) + fmlp + (batch.bond_center,
                                             batch.bond_crystal,
                                             batch.bond_offsets, n_atoms,
                                             n_crys),
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
    accum_args = (msg, batch.sym_rep, batch.sym_dest, batch.sym_offsets,
                  n_eu)
    # the incidences as an (Eu, Au) matrix, a self-image row's two
    # incidences summed into one entry of 2
    spmat = torch.sparse_coo_tensor(
        torch.stack([batch.sym_dest[:n_incid], batch.sym_rep[:n_incid]]),
        torch.ones(n_incid, device=msg.device),
        size=(n_eu, msg.shape[0]),
        check_invariants=True).coalesce().to_sparse_csr()
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
             shape={"atoms": n_atoms, "und": n_eu, "und_angles":
                    a_u.shape[0], "real_und_angles": real_au, "dim": dim}),
        dict(name="sym_accum_fwd", counter="sym_accum",
             path="FAST_FUSED_SYM", wrapper=ops.sym_accum,
             plain=ref.sym_accum_ref, args=accum_args,
             library=lambda: torch.sparse.mm(spmat, msg),
             source=f"{CSRC}/segment_sum.cu", replaces=f"{TPU_FILE}:1112",
             flops=n_incid * dim,
             bytes=f * (real_au * dim + n_incid + n_eu + 1 + n_eu * dim),
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
    twice for equal bits.  Returns the number of cases checked."""
    n = 0
    for label, batch in sym_edge_batches(seed).items():
        for c in sym_kernel_cases(params, batch):
            _check_close(f"{c['name']} on {label}", c["wrapper"](*c["args"]),
                         c["plain"](*c["args"]))
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
        n += 2
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
            n += 1
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

    def seg_case(name, values, ids, offsets, rows, real, primary):
        d = values.shape[1]
        offs64 = offsets.long()
        return dict(
            name=name, primary=primary, wrapper=ops.fused_segment_sum,
            plain=ref.sorted_segment_sum_ref,
            args=(values, ids, offsets, rows),
            library=lambda: torch.segment_reduce(
                values[:real], "sum", offsets=offs64, axis=0),
            source=f"{CSRC}/segment_sum.cu",
            replaces=f"{TPU_DIR}/fused_segment_sum.py:99",
            flops=real * d, bytes=f * (real * d + rows + 1 + rows * d),
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
            plain=ref.gated_mlp_packed_ref,
            args=(x, p["w"], p["b"], p["ln_scale"], p["ln_bias"]),
            composition=composition, split=True,
            source=f"{CSRC}/gated_mlp.cu",
            replaces=f"{TPU_DIR}/fused_gated_mlp.py:52",
            flops=2 * m * d_in * d2 + m * d2,
            bytes=f * (m * d_in + d_in * d2 + 3 * d2 + m * d2 // 2),
            shape={"rows": m, "d_in": d_in, "dim": d2 // 2})

    k_rbf, k_four = params["rbf_freqs"].shape[0], cfg.num_fourier
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
    give the same bits on a second call.  A bf16 case of kernels 2, 3 and
    4a (``bf16_cases``) is bound at the bf16 peak and times the split-f32
    kernel on the same values in turns with it (``twin``).  A conv case
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
                    check(f"{c['name']} {key}", c[key](), want)
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
                # the split-f32 kernel on the same values, in turns
                twin_dev = _time_device(c["twin"])
                rows[-1].update(f32_ms=twin_ms, f32_device_ms=twin_dev)
                lib += (f", split f32 {twin_ms:.4f} ms (device "
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
    """Each wrapper's recompute backward against plain autograd through
    its ``kernels.ref`` version on the same CUDA tensors: the gradients of
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
    crystal).  Each runs twice: the two calls must give equal bits.  The
    force readout also runs with its operands rounded to bf16 (kernel 4a's
    bf16 path, within one bf16 rounding of its plain version).  Returns
    the number of cases checked."""
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
                     _check_close)):
                got = wrapper(*args)
                if not _equal(got, wrapper(*args)):
                    raise RuntimeError(f"{name} on {label}, D = {d}: two "
                                       "calls on the same inputs differ")
                check(f"{name} on {label}, D = {d}", got, plain(*args))
                n += 1
    return n


def tier_edge_cases(f, ids, csr) -> int:
    """The unfused tier's kernels against their plain versions on ragged
    and edge inputs: the segment sum at D = 3 and 64 with empty rows,
    every edge padded and S of 1, 7 and 1000, and once from a view that is
    not 16-byte aligned (the scalar path at D = 64); the GatedMLP at M = 1,
    255 and 257, an input width that is no multiple of 4, d_in 0, 7, 300
    and 1,000 (several and partial K chunks) at D 8, 32 and 128, and from
    unaligned views (its 4-byte copies); the RBF at
    r = 0, 1e-9, r_cut and beyond; the Fourier basis at 0 and pi; then
    both bases at the edges of their tiles (``basis_edge_cases``)."""
    n = 0
    for d in (3, 64):
        for rows, n_edges, n_real in ((1, 10, 10), (7, 40, 0), (7, 50, 31),
                                      (1000, 3000, 2500)):
            seg, offs = csr(rows, n_edges, n_real)
            args = (f(n_edges, d), seg, offs, rows)
            _check_close(f"segment_sum case {n}", ops.fused_segment_sum(
                *args), ref.sorted_segment_sum_ref(*args))
            n += 1
    seg, offs = csr(37, 300, 260)
    unaligned = f(300 * 64 + 1)[1:].view(300, 64)
    args = (unaligned, seg, offs, 37)
    _check_close(f"segment_sum case {n}", ops.fused_segment_sum(*args),
                 ref.sorted_segment_sum_ref(*args))
    n += 1
    for m, d_in, d in ((1, 192, 64), (255, 256, 64), (257, 192, 64),
                       (33, 13, 16), (300, 300, 128), (40, 7, 8),
                       (513, 1000, 32), (20, 0, 64)):
        args = (f(m, d_in), f(d_in, 2 * d, scale=0.1), f(2 * d),
                f(2 * d).abs() + 0.5, f(2 * d))
        _check_close(f"gated_mlp case {n}", ops.fused_gated_mlp_packed(
            *args), ref.gated_mlp_packed_ref(*args))
        n += 1
    # x and W from views that are not 16-byte aligned (4-byte copies)
    args = (f(100 * 192 + 1)[1:].view(100, 192),
            f(192 * 128 + 1, scale=0.1)[1:].view(192, 128), f(128),
            f(128).abs() + 0.5, f(128))
    _check_close(f"gated_mlp case {n}", ops.fused_gated_mlp_packed(*args),
                 ref.gated_mlp_packed_ref(*args))
    n += 1
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
    # the device time of the kernels they launch
    events = sorted((e for e in averages if e.device_type != DeviceType.CPU
                     and e.self_device_time_total > 0),
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


def plain_path_check(params, cfg, batch) -> dict:
    """Loss and every gradient leaf of the kernels' path against the plain
    path (``plain_config``, at the same precision) on the card; also the
    launches of the kernels' forward (its backward launches none).  In f32
    each within ``1e-4 * max(1, max|plain|)``; at a bf16 compute dtype
    (the mixed tiers) DESIGN.md §4's bounds: the loss within ``3e-2 *
    max(1, |plain|)``, the gradients within 5% relative global norm and
    cosine 0.999."""
    ops.reset_launch_counts()
    loss_k, _ = chgnet_loss_fn(params, cfg, batch, chgnet_mptrj.LOSS)
    g_k = grads_of(loss_k, params)
    launched = ops.launch_counts()
    if not any(launched.values()):
        raise RuntimeError("the kernels' path launched no kernel")
    loss_p, _ = chgnet_loss_fn(params, plain_config(cfg), batch,
                               chgnet_mptrj.LOSS)
    g_p = grads_of(loss_p, params)
    torch.cuda.synchronize()
    if resolve_policy(cfg.precision).low_precision_compute:
        err_l, tol_l, _ = _check_bf16("train loss", loss_k.detach(),
                                      loss_p.detach())
        return {"loss": loss_p.item(), "loss_max_abs_err": err_l,
                "loss_tolerance": tol_l, "grad_leaves": len(g_k),
                **_check_grads_mixed(g_k, g_p), "launches": launched}
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
                prefetch: bool = False) -> dict:
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
    the share of packing the thread hides is 1 - wait / (pack + copy)."""
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
        plain = plain_path_check(tr.params, cfg, first)
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
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()
        stats = ({k: pf.stats[k] - stats0[k] for k in stats0} if pf
                 else None)
        check_launches(name, counts, per_forward, steps)
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
            "launches": counts,
            "caps_per_step": [e[3] for e in steps_log],
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
    ``_check_bf16``) and, with ``reference`` (an f32 config of the same
    function), against that config's outputs at the same bound; one
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
    forwards = serve.engine.batches_packed - packed0
    check_launches(f"serve {name}", counts, per_forward, forwards)
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
        "peak_mem_bytes": peak, "launches": counts,
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
    src10 = f"{CSRC}/swiglu.cu"
    src11 = f"{CSRC}/flash_attention.cu"
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def swiglu(name, m, weights, act, dtype, path=None, yardstick=False):
        wg, wu, wd = weights
        d, f = wg.shape
        x = _rand(gen, (m, d), dtype)
        size = x.element_size()
        bf16 = dtype == torch.bfloat16
        composition = None
        if path or yardstick:
            def composition(x=x, p={"wg": wg, "wu": wu, "wd": wd}, act=act):
                return layers.gated_mlp_apply(p, x, act, use_pallas=False)
        cases.append(dict(
            name=name, counter="fused_swiglu", path=path,
            wrapper=lambda *a, act=act: ops.fused_swiglu(*a, activation=act),
            plain=lambda *a, act=act: ref.fused_swiglu_ref(*a, act),
            args=(x, wg, wu, wd), source=src10, composition=composition,
            replaces=f"{LM_TPU_DIR}/fused_swiglu.py:49", split=not bf16,
            check=_check_bf16 if bf16 else _check_close,
            peak=PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS,
            flops=6 * m * d * f, bytes=size * (2 * m * d + 3 * d * f),
            plan=_plan_row(ops.swiglu_plan(m, d, f, size, sms)),
            shape={"M": m, "D": d, "F": f, "dtype": str(dtype)[6:],
                   "activation": act}))

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


def lm_forced_run(cfg, params, tokens, steps: int, max_len: int,
                  use_pallas: bool, forced=None, cache_dtype=torch.bfloat16):
    """Prefill then ``steps`` decode steps through ``models.transformer``
    (which return logits), each step fed this run's greedy token or, with
    ``forced``, the given one.  Returns the prefill's last-position logits
    and every step's logits (f32, (B, V) each) and the tokens fed."""
    b, s = tokens.shape
    positions = torch.arange(s, device="cuda").expand(b, s)
    outs, fed = [], []
    with torch.inference_mode():
        logits, cache = transformer.prefill(
            cfg, params, tokens, positions, max_len, use_pallas=use_pallas,
            cache_dtype=cache_dtype)
        outs.append(logits[:, -1].float())
        for t in range(steps):
            tok = forced[t] if forced is not None \
                else outs[-1].argmax(-1, keepdim=True)
            fed.append(tok)
            logits, cache = transformer.decode_step(
                cfg, params, tok, cache, torch.full_like(tok, s + t),
                use_pallas=use_pallas)
            outs.append(logits[:, 0].float())
    return outs, fed


def lm_serve_run(cfg, params, tokens, steps: int, use_pallas: bool) -> dict:
    """The serving path through its entry points: ``serve.lm.prefill_step``
    then ``steps`` greedy ``decode_step``s, each part on the host clock
    around work that ends in a synchronise, with the launch counters set
    to 0 just before each part and read just after, and the peak memory."""
    b, s = tokens.shape
    positions = torch.arange(s, device="cuda").expand(b, s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    nxt, cache = lm.prefill_step(cfg, params, tokens, positions, LM_MAX_LEN,
                                 use_pallas=use_pallas)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_counts = ops.launch_counts()
    ops.reset_launch_counts()
    tok = nxt[:, None]
    t0 = time.perf_counter()
    for t in range(steps):
        tok, cache = lm.decode_step(cfg, params, tok, cache,
                                    torch.full_like(tok, s + t),
                                    use_pallas=use_pallas)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    decode_counts = ops.launch_counts()
    layers = cfg.num_layers if use_pallas else 0
    check_launches("lm prefill", prefill_counts, {"fused_swiglu": layers}, 1)
    check_launches("lm decode", decode_counts, {"fused_swiglu": layers},
                   steps)
    return {"ms_per_prefill": t_prefill * 1e3,
            "prompt_tokens_per_s": b * s / t_prefill,
            "ms_per_decode_step": t_decode / steps * 1e3,
            "decode_tokens_per_s": b * steps / t_decode,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "prefill_launches": prefill_counts["fused_swiglu"],
            "decode_launches": decode_counts["fused_swiglu"]}


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
    plain, fed = lm_forced_run(cfg, params, tokens, 4, 160, False,
                               cache_dtype=torch.float32)
    ops.reset_launch_counts()
    got, _ = lm_forced_run(cfg, params, tokens, 4, 160, True, forced=fed,
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

    plain, fed = lm_forced_run(cfg, params, tokens, LM_DECODE, LM_MAX_LEN,
                               False)
    got, _ = lm_forced_run(cfg, params, tokens, LM_DECODE, LM_MAX_LEN, True,
                           forced=fed)
    errs = [_check_bf16(f"lm {'prefill' if i == 0 else f'decode {i}'}", g, p)
            for i, (g, p) in enumerate(zip(got, plain))]
    agree = [float((g.argmax(-1) == p.argmax(-1)).float().mean())
             for g, p in zip(got, plain)]
    print(f"lm teacher-forced, kernels' path against plain: max abs error "
          f"{max(e[0] for e in errs):.3e} (smallest tolerance "
          f"{min(e[1] for e in errs):.3e}), smallest cosine "
          f"{min(e[2] for e in errs):.6f}; greedy tokens agree "
          f"{sum(agree) / len(agree):.3f} (prefill + {LM_DECODE} steps)",
          flush=True)

    runs = {"plain": [], "kernels": []}
    for name in ("plain", "kernels", "kernels", "plain"):
        r = lm_serve_run(cfg, params, tokens, LM_DECODE, name == "kernels")
        runs[name].append(r)
        print(f"lm serve {name}: {r['ms_per_prefill']:.2f} ms per prefill "
              f"({r['prompt_tokens_per_s']:.0f} prompt tokens/s), "
              f"{r['ms_per_decode_step']:.3f} ms per decode step "
              f"({r['decode_tokens_per_s']:.1f} tokens/s), peak "
              f"{r['peak_mib']:.0f} MiB, fused_swiglu launches "
              f"{r['prefill_launches']} + {r['decode_launches']}",
              flush=True)
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
        "teacher_forced": {
            "max_abs_err": [e[0] for e in errs],
            "tolerance": [e[1] for e in errs],
            "cosine": [e[2] for e in errs],
            "token_agreement": agree},
        "serve": runs, "f32_two_layers": f32,
        "kernel_extra_shapes": [r for r in krows if r not in primary]}
    if traces:
        row["profile"] = traces
    return row, primary


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the mixed tiers' plain bf16 products (torch.matmul, cuBLAS) sum in
    # f32, as the JAX package's do (DESIGN.md §4)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False

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
                "message_passing_bf16", "basis"):
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
    # the bf16 paths of kernels 2, 3 and 4a (the mixed tiers); their bf16
    # and f32 copies of the batch's tables are freed at once (the train
    # phases' peak memory must not hold them)
    bf16_train_cases = bf16_cases(train_cases + sym_cases)
    bf16_rows = kernel_phase(bf16_train_cases)
    bf16_train_paths = [c["path"] for c in bf16_train_cases]
    del bf16_train_cases
    serve_cases = kernel_cases(tree, cfg, probe[big])
    serve_kernel_rows = kernel_phase(serve_cases)
    serve_tier_rows = kernel_phase(tier_kernel_cases(tree, cfg, probe[big]))
    serve_sym_cases = sym_kernel_cases(tree, probe[big])
    serve_sym_rows = kernel_phase(serve_sym_cases)
    bf16_serve_cases = bf16_cases(serve_cases + serve_sym_cases)
    serve_bf16_rows = kernel_phase(bf16_serve_cases)
    bf16_serve_paths = [c["path"] for c in bf16_serve_cases]
    del bf16_serve_cases, serve_cases
    print(f"kernels: {edge_case_phase(tree, args.seed)} ragged-layout and "
          "edge cases agree with the plain versions", flush=True)

    _stamp(t_start, "kernels and edge cases")
    # 4. the wrappers' backwards against plain autograd, on the training
    # batch
    backward_rows = backward_phase(
        train_cases + tier_cases + sym_backward_cases(sym_cases), args.seed)

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
    }
    for row in serve_kernel_rows:
        row["launches"] = serve_rows["FAST_FUSED"]["launches"][row["wrapper"]]
    for row in serve_tier_rows:
        row["launches"] = serve_rows["FAST_PALLAS"]["launches"][row["wrapper"]]
    for row, c in zip(serve_sym_rows, serve_sym_cases):
        row["launches"] = serve_rows[c["path"]]["launches"][row["wrapper"]]
    for row, path in zip(serve_bf16_rows, bf16_serve_paths):
        # [pair+und] is on no mixed path (FAST_FUSED_SYM at "mixed"
        # raises: kernels 5 and 6 take f32 only)
        row["launches"] = serve_rows[path]["launches"][row["wrapper"]] \
            if path in serve_rows else 0
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
              "FAST_PALLAS": ("rbf_kernel", "fourier_kernel")}
    # operators whose device time in a training step is printed: the
    # gathers' backward over the padded rows
    padded = ("embedding_dense_backward",)
    fused, sym = chgnet_mptrj.FAST_FUSED, chgnet_mptrj.FAST_FUSED_SYM
    mixed = chgnet_mptrj.FAST_FUSED_MIXED
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
            ("REFERENCE", chgnet_mptrj.REFERENCE, train_caps, 2, {},
             False)):
        train_rows[name] = train_phase(
            name, tcfg, ds, caps, steps, per, args.seed, args.profile,
            traced.get(name, ()),
            padded if tcfg in (fused, sym, mixed) else (), prefetch)
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
    # the bf16 rows: directed on FAST_FUSED_MIXED (through the
    # prefetcher), [pair] on FAST_FUSED_HALF_MIXED, [pair+und] on no path
    bf16_path = {"FAST_FUSED_MIXED": "FAST_FUSED_MIXED prefetch",
                 "FAST_FUSED_HALF_MIXED": "FAST_FUSED_HALF_MIXED"}
    bf16_on_path, bf16_extra = [], []
    for row, case_path in zip(bf16_rows, bf16_train_paths):
        path = bf16_path.get(case_path)
        row["launches"] = train_rows[path]["launches"][row["wrapper"]] \
            if path else 0
        if path and not row["launches"]:
            raise RuntimeError(f"{row['name']} was not launched on {path}")
        (bf16_on_path if path else bf16_extra).append(row)

    _stamp(t_start, "train")
    # 9. learns, in f32 and at the mixed tier
    learns = learns_phase(args.seed)
    learns_mixed = learns_phase(args.seed, mixed)
    primary = [r for r, c in zip(tier_rows, tier_cases) if c["primary"]]
    extra = [r for r, c in zip(tier_rows, tier_cases) if not c["primary"]]
    print(json.dumps({"train": dict(
        train_rows, FUSED_MLP_PALLAS=fused_mlp,
        FAST_FUSED_HALF_vs_FAST_FUSED=half_vs_fused, backward=backward_rows,
        learns=learns, learns_mixed=learns_mixed,
        kernel_extra_shapes=extra + bf16_extra,
        dataset={"crystals": len(ds), "caps": vars(train_caps),
                 "ladder": [vars(b) for b in train_ladder.buckets]})}))
    _stamp(t_start, "learns")
    # 10. the LM: every CHGNet phase's state is gone; return its cache
    torch.cuda.empty_cache()
    lm_row, lm_kernel_rows = lm_phase(args.seed, args.profile)
    print(json.dumps({"lm": lm_row}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    print(json.dumps({"kernels": rows + primary + sym_rows + bf16_on_path
                      + lm_kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
