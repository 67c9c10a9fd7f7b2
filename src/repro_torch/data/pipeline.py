"""Training-side batch iteration and prefetch, PyTorch port of
``repro.data.pipeline``.

``BatchIterator`` draws global batches from a sampler (paper C6; with
``load_balance="cost"`` the LPT ``CostBalanceSampler`` of DESIGN.md §6)
and packs each into padded CPU ``CrystalGraphBatch``es with
``batching.batch_crystals``: into a fixed ``BatchCapacities``, or into the
smallest bucket of a ``CapacityLadder`` that fits (``batching.ladder_for``
sizes one from the dataset).  ``BalancedBatchIterator`` yields
``StepPlan``s instead: one optimizer step as several cost-sorted
microbatches, each packed into its own smallest bucket, with the step's
global loss denominators, for the Trainer's accumulation path.

Over ``num_devices > 1`` (data parallelism) every rank runs the same
sampler from the same seed over the whole global batch, picks the bucket
from all shards of the step (one shape on every rank, as the JAX
package's stacked leaves need) and packs only its own: ``shard=r`` yields
rank r's batch, equal bit for bit to the JAX package's stacked leaves
``[r]``; ``shard=None`` yields the list of every shard's batch (tests,
one-process emulation).  A plan's microbatch that leaves a device idle
gives it an all-padding shard.

Quarantined dataset indices are dropped from every later batch, and
``tag_indices`` wraps each batch in a ``TaggedBatch`` of the step's
global indices, so that a rollback can trace a divergence back to its
samples and quarantines the same set on every rank.  ``Prefetcher``
packs the next items on a background thread and, given a CUDA device,
copies each from pinned host memory on a stream of its own (paper C8's
separate copy stream), while the caller's step runs: a rank's shard to
that rank's device.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import queue
import threading
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.batching import BatchCapacities, CapacityLadder, batch_crystals
from repro_torch.batching.balance import (
    StepPlan,
    crystal_slots_for,
    plan_microbatches,
    shard_cost_totals,
)
from repro_torch.batching.cost import DEFAULT_COST_MODEL, CostModel
from repro_torch.core.graph import CrystalGraphBatch
from repro_torch.core.losses import global_denominators
from repro_torch.runtime import trace
from repro_torch.runtime.fault import TransientSampleError
from .sampler import (
    CostBalanceSampler,
    DefaultSampler,
    LoadBalanceSampler,
    _epoch_slices,
)
from .synthetic import SyntheticDataset

log = logging.getLogger("repro_torch.data")


class TaggedBatch(NamedTuple):
    """A packed batch (or ``StepPlan``) plus the dataset indices it was
    built from.  The Trainer unwraps it before the step and keeps the
    indices in a ring buffer, so that a divergence rollback can quarantine
    the streak's source samples (DESIGN.md §8)."""

    indices: np.ndarray
    batch: Any


def _check_devices(global_batch: int, num_devices: int,
                   shard: int | None) -> None:
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if global_batch < num_devices:
        raise ValueError(
            f"global_batch {global_batch} < num_devices {num_devices}")
    if shard is not None and not 0 <= shard < num_devices:
        raise ValueError(f"shard {shard} out of range for {num_devices} "
                         "devices")


def build_device_batch(
    ds: SyntheticDataset,
    indices: np.ndarray,
    caps: BatchCapacities,
    *,
    num_crystal_slots: int | None = None,
    validate: bool = True,
) -> CrystalGraphBatch:
    return batch_crystals(
        [ds.crystals[i] for i in indices],
        [ds.graphs[i] for i in indices],
        caps,
        num_crystal_slots=num_crystal_slots,
        validate=validate,
    )


class BatchIterator:
    """Epoch iterator producing padded CPU batches: one a step on one
    device, rank ``shard``'s over several, or (``shard=None``) the list
    of every device's."""

    def __init__(
        self,
        ds: SyntheticDataset,
        global_batch: int,
        num_devices: int,
        caps: BatchCapacities | CapacityLadder,
        *,
        load_balance: bool | str = True,
        seed: int = 0,
        drop_last: bool = True,
        validate_layout: bool = True,
        cost_model: CostModel | None = None,
        tag_indices: bool = False,
        shard: int | None = None,
    ):
        _check_devices(global_batch, num_devices, shard)
        self.ds = ds
        self.global_batch = global_batch
        self.num_devices = num_devices
        self.shard = shard
        self.caps = caps
        self.drop_last = drop_last
        # quarantine (DESIGN.md §8): indices here are dropped from every
        # later batch (the crystal-slot pad absorbs the shorter shard);
        # tag_indices wraps each yield in a TaggedBatch
        self.tag_indices = tag_indices
        self.quarantine: set[int] = set()
        self.validate_layout = validate_layout
        if load_balance == "cost":
            # LPT over a cost model (DESIGN.md §6): shards may hold unequal
            # sample counts, so the crystal-slot pad takes LPT's headroom
            model = cost_model if cost_model is not None \
                else DEFAULT_COST_MODEL
            self.crystal_slots = crystal_slots_for(global_batch, num_devices)
            self.sampler = CostBalanceSampler(
                model.predict_dataset(ds), seed,
                max_items=self.crystal_slots)
        else:
            self.crystal_slots = math.ceil(global_batch / num_devices)
            counts = ds.feature_counts()
            self.sampler = (LoadBalanceSampler(counts, seed) if load_balance
                            else DefaultSampler(counts, seed))

    def _caps_for(self, shards: list[np.ndarray]) -> BatchCapacities:
        """One capacity for all shards of this step: the smallest bucket
        that fits the largest (every rank computes the same)."""
        if isinstance(self.caps, BatchCapacities):
            return self.caps
        na = nb = ng = 0
        for s in shards:
            na = max(na, sum(self.ds.crystals[i].num_atoms for i in s))
            nb = max(nb, sum(self.ds.graphs[i].num_bonds for i in s))
            ng = max(ng, sum(self.ds.graphs[i].num_angles for i in s))
        return self.caps.bucket_for(na, nb, ng)

    def _pack(self, shards: list[np.ndarray]):
        """The step's batch at the bucket of all its shards: this rank's
        (``shard``), the only one, or the list of every shard's."""
        caps = self._caps_for(shards)

        def build(s):
            return build_device_batch(
                self.ds, s, caps, num_crystal_slots=self.crystal_slots,
                validate=self.validate_layout)

        if self.shard is not None:
            return build(shards[self.shard])
        if len(shards) == 1:
            return build(shards[0])
        return [build(s) for s in shards]

    def add_quarantine(self, indices) -> None:
        """Exclude dataset indices from all future batches (the Trainer's
        ``on_quarantine`` hook points here)."""
        self.quarantine.update(int(i) for i in np.asarray(indices).ravel())

    def _filter_quarantined(self, shards: list[np.ndarray]):
        """Drop quarantined indices; None if any shard would go empty
        (skip the step)."""
        if not self.quarantine:
            return shards
        q = np.fromiter(self.quarantine, dtype=np.int64)
        out = [s[~np.isin(s, q)] for s in shards]
        if any(len(s) == 0 for s in out):
            return None
        return out

    def __iter__(self):
        for _idx, shards in self.sampler.epoch(
                self.global_batch, self.num_devices,
                drop_last=self.drop_last):
            shards = self._filter_quarantined(shards)
            if shards is None:
                continue
            batch = self._pack(shards)
            yield TaggedBatch(np.concatenate(shards), batch) \
                if self.tag_indices else batch


class BalancedBatchIterator:
    """Epoch iterator producing :class:`StepPlan` s (DESIGN.md §6).

    One yielded plan = one optimizer step = ``num_micro`` microbatches,
    each packed into its OWN smallest-fitting capacity bucket.  The
    Trainer's accumulation path (``train.trainer.make_chgnet_accum_step_
    fns``) sums the per-microbatch gradients, whose global-denominator
    losses make the summed update equal a single big-batch step: the
    big-crystal microbatch pays the big bucket, the rest do not.  Over
    several devices a plan is ``num_micro`` x ``num_devices`` shards: rank
    ``shard`` takes its column (``micro[m]`` its shard of microbatch m),
    with the step's global denominators; ``shard=None`` gives each
    microbatch as the list of its shards.
    """

    def __init__(
        self,
        ds: SyntheticDataset,
        global_batch: int,
        num_devices: int,
        caps: BatchCapacities | CapacityLadder,
        *,
        num_micro: int = 1,
        cost_model: CostModel | None = None,
        seed: int = 0,
        drop_last: bool = True,
        validate_layout: bool = True,
        shard: int | None = None,
    ):
        _check_devices(global_batch, num_devices, shard)
        self.ds = ds
        self.global_batch = global_batch
        self.num_devices = num_devices
        self.shard = shard
        self.caps = caps
        self.num_micro = max(1, num_micro)
        self.cost_model = cost_model if cost_model is not None \
            else DEFAULT_COST_MODEL
        self.costs = self.cost_model.predict_dataset(ds)
        self.atoms = np.array([c.num_atoms for c in ds.crystals])
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.validate_layout = validate_layout
        # static crystal-slot pad, fixed per (global_batch, num_micro,
        # num_devices): one crystal-axis shape per bucket
        self.crystal_slots = crystal_slots_for(
            global_batch, num_devices, self.num_micro)
        self.quarantine: set[int] = set()

    add_quarantine = BatchIterator.add_quarantine
    _caps_for = BatchIterator._caps_for
    _pack = BatchIterator._pack

    def update_cost_model(self, model: CostModel) -> None:
        """Swap in a refit cost model (live refits, DESIGN.md §6): the
        Trainer calls it through ``on_cost_model``, and every later
        ``plan_step`` packs with the new coefficients."""
        self.cost_model = model
        self.costs = model.predict_dataset(self.ds)

    def plan_step(self, idx: np.ndarray) -> StepPlan:
        """Pack one global batch's indices into a balanced StepPlan."""
        idx = np.asarray(idx)
        plan = plan_microbatches(
            self.costs[idx], self.num_devices, self.num_micro,
            max_items=self.crystal_slots)
        micro_batches = []
        shard_costs = np.zeros((len(plan), self.num_devices), np.float64)
        micro_sizes = np.zeros((len(plan), 3), np.float64)
        for m, shards_pos in enumerate(plan):
            shards = [idx[pos] for pos in shards_pos]
            micro_batches.append(self._pack(shards))
            shard_costs[m] = shard_cost_totals(self.costs, shards)
            # the microbatch's real feature totals over all its shards:
            # the live cost-model refit pairs them with the measured
            # microbatch times (the slowest rank's, on a mesh)
            flat = np.concatenate(shards)
            micro_sizes[m] = (
                sum(self.ds.crystals[i].num_atoms for i in flat),
                sum(self.ds.graphs[i].num_bonds for i in flat),
                sum(self.ds.graphs[i].num_angles for i in flat),
            )
        denoms = global_denominators(len(idx), int(self.atoms[idx].sum()))
        return StepPlan(micro=micro_batches, denoms=denoms,
                        shard_costs=shard_costs, num_real=len(idx),
                        micro_sizes=micro_sizes)

    def __iter__(self):
        n = len(self.ds)
        perm = self.rng.permutation(n)
        for s, e in _epoch_slices(n, self.global_batch, self.num_devices,
                                  self.drop_last):
            idx = perm[s:e]
            if self.quarantine:
                q = np.fromiter(self.quarantine, dtype=np.int64)
                idx = idx[~np.isin(idx, q)]
                if len(idx) < self.num_devices:
                    continue  # too few survivors to fill every shard
            yield self.plan_step(idx)


def _map_batches(item, fn):
    """``fn`` applied to every batch or tensor of a prefetched item: the
    item itself, a ``TaggedBatch``'s batch, each of a ``StepPlan``'s
    microbatches, each shard of a list."""
    if isinstance(item, TaggedBatch):
        return TaggedBatch(item.indices, _map_batches(item.batch, fn))
    if isinstance(item, list):
        return [_map_batches(x, fn) for x in item]
    if isinstance(item, StepPlan):
        return dataclasses.replace(
            item, micro=[_map_batches(m, fn) for m in item.micro])
    if torch.is_tensor(item) or isinstance(item, CrystalGraphBatch):
        return fn(item)
    raise TypeError("Prefetcher moves CrystalGraphBatch, tensor, "
                    f"TaggedBatch, StepPlan or list items, got "
                    f"{type(item).__name__}")


class _OnDevice(NamedTuple):
    """A prefetched item on the card and the event recorded after its
    copies on the prefetcher's stream."""
    value: Any
    ready: torch.cuda.Event


class Prefetcher:
    """Background-thread prefetch of up to ``depth`` batches.

    A worker-thread exception is captured and re-raised in the consumer at
    the point of failure: a bad batch must fail the epoch loudly, not
    silently truncate it.  Two exceptions (DESIGN.md §8):

      - :class:`~repro_torch.runtime.fault.TransientSampleError` from the
        source is retried with bounded exponential backoff: the offending
        index is logged + recorded in ``self.quarantined`` and the stream
        moves on (the source must be resumable across the raise).  Only
        ``max_retries`` CONSECUTIVE transient failures escalate to the
        consumer.
      - Early consumer exit: breaking out of the ``for`` loop (or any
        ``close()``) unblocks a worker stuck on the full queue and joins
        it with a timeout.

    ``device=None`` yields the items as the source gives them.  An item
    is a ``CrystalGraphBatch``, a tensor, a ``TaggedBatch`` of one or a
    ``StepPlan`` (every microbatch moves; a ``TaggedBatch``'s indices stay
    on the host).  A CUDA ``device`` needs CUDA (it raises without it, as
    the entry points do): the worker pins each batch and copies it with
    ``non_blocking=True`` on a stream of its own, records one event after
    the item's last copy and waits for it on its own thread, so the
    pinned sources outlive their copies; the consumer's current stream
    waits on that event, and every copied batch's memory is recorded on
    that stream so that the caching allocator does not reuse it while the
    consumer's work on it is queued.  Another device gets
    ``batch.to(device)``.

    ``stats`` counts, in seconds: ``source_s``, the worker's time in the
    source (packing, for a ``BatchIterator``); ``copy_s``, its time
    pinning and copying; ``wait_s``, the consumer's time blocked on the
    queue; and ``items``, the items handed over.  The share of packing
    that the thread hides is ``1 - wait_s / (source_s + copy_s)``.
    While ``runtime.trace`` records (a profiler runs on the thread that
    steps), the same clock reads also give each item's spans:
    ``prefetch.pack`` over the time ``source_s`` adds and
    ``prefetch.copy`` over the time ``copy_s`` adds, with the item's
    ordinal among those the worker produced.
    """

    _STOP = object()

    def __init__(self, iterator, depth: int = 2, device=None, *,
                 max_retries: int = 3, backoff: float = 0.02):
        self.device = None if device is None else torch.device(device)
        self._stream = None
        if self.device is not None and self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"Prefetcher(device={str(device)!r}) needs CUDA, which "
                    "is not available; pass device=None to prefetch CPU "
                    "batches")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self.device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._error: BaseException | None = None
        self.max_retries = max_retries
        self.backoff = backoff
        self.quarantined: list[int | None] = []
        self.stats = {"items": 0, "source_s": 0.0, "copy_s": 0.0,
                      "wait_s": 0.0}
        self._closed = threading.Event()
        self._source = iter(iterator)
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        """put that gives up when the consumer closed us."""
        while not self._closed.is_set():
            try:
                self.q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, item):
        if self._stream is None:
            return _map_batches(item, lambda b: b.to(self.device))
        pinned = []

        def copy(b):
            pinned.append(b.pin_memory())
            return pinned[-1].to(self.device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            moved = _map_batches(item, copy)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        # the pinned sources must stay alive until their copies are done:
        # wait here, on the worker's thread, while the consumer's step runs
        ready.synchronize()
        return _OnDevice(moved, ready)

    def _worker(self):
        retries = produced = 0
        clock = time.perf_counter
        try:
            if self._stream is not None:
                # the current device and stream are per thread
                torch.cuda.set_device(self.device)
            while not self._closed.is_set():
                t0 = clock()
                try:
                    item = next(self._source)
                except StopIteration:
                    break
                except TransientSampleError as exc:
                    retries += 1
                    self.quarantined.append(exc.index)
                    log.warning(
                        "prefetch: transient sample failure (index=%s), "
                        "quarantined; retry %d/%d", exc.index, retries,
                        self.max_retries)
                    if retries > self.max_retries:
                        self._error = exc
                        break
                    time.sleep(self.backoff * (2 ** (retries - 1)))
                    continue
                retries = 0
                t1 = clock()
                self.stats["source_s"] += t1 - t0
                traced = trace.on()
                if traced:
                    trace.record("prefetch.pack", t0, t1, produced)
                if self.device is not None:
                    item = self._to_device(item)
                    t2 = clock()
                    self.stats["copy_s"] += t2 - t1
                    if traced:
                        trace.record("prefetch.copy", t1, t2, produced)
                produced += 1
                if not self._put(item):
                    return  # closed mid-put: consumer is gone
        except BaseException as e:  # re-raised in the consumer
            self._error = e
        self._put(self._STOP)

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker: signal, drain the queue (unblocking a full
        ``put``), join with ``timeout``.  Idempotent; called automatically
        when the consumer's iteration ends for ANY reason."""
        self._closed.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout)

    def __iter__(self):
        clock = time.perf_counter
        try:
            while True:
                t0 = clock()
                try:
                    item = self.q.get(timeout=0.1)
                except queue.Empty:
                    self.stats["wait_s"] += clock() - t0
                    if self._closed.is_set() or not self.thread.is_alive():
                        break  # worker gone without a sentinel
                    continue
                self.stats["wait_s"] += clock() - t0
                if item is self._STOP:
                    break
                if isinstance(item, _OnDevice):
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(item.ready)
                    _map_batches(item.value,
                                 lambda b: b.record_stream(stream))
                    item = item.value
                self.stats["items"] += 1
                yield item
            if self._error is not None:
                raise self._error
        finally:
            self.close()
