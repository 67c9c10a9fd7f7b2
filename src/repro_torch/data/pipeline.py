"""Training-side batch iteration and prefetch, PyTorch port of the
single-device part of ``repro.data.pipeline``.

``BatchIterator`` draws global batches from a sampler (paper C6) and
packs each into one padded CPU ``CrystalGraphBatch`` with
``batching.batch_crystals``: into a fixed ``BatchCapacities``, or into the
smallest bucket of a ``CapacityLadder`` that fits (``batching.ladder_for``
sizes one from the dataset).  Quarantined dataset indices are dropped
from every later batch.  ``Prefetcher`` packs the next batches on a
background thread and, given a CUDA device, copies each from pinned host
memory on a stream of its own (paper C8's separate copy stream), while
the caller's step runs.  Multi-device sharding, the cost balancer and
``BalancedBatchIterator`` come with ROADMAP 'Modules to port' item 9 and
raise here.
"""
from __future__ import annotations

import logging
import math
import queue
import threading
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.batching import BatchCapacities, CapacityLadder, batch_crystals
from repro_torch.core.graph import CrystalGraphBatch
from repro_torch.runtime.fault import TransientSampleError
from .sampler import DefaultSampler, LoadBalanceSampler
from .synthetic import SyntheticDataset

_TODO = "is not ported yet: ROADMAP 'Modules to port' item 9"
log = logging.getLogger("repro_torch.data")


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
    """Epoch iterator producing padded single-device CPU batches."""

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
    ):
        if num_devices != 1:
            raise NotImplementedError(f"num_devices={num_devices} {_TODO}")
        if load_balance == "cost":
            raise NotImplementedError(f'load_balance="cost" {_TODO}')
        if global_batch < num_devices:
            raise ValueError(
                f"global_batch {global_batch} < num_devices {num_devices}")
        self.ds = ds
        self.global_batch = global_batch
        self.num_devices = num_devices
        self.caps = caps
        self.drop_last = drop_last
        # quarantine (DESIGN.md §8): indices here are dropped from every
        # later batch (the crystal-slot pad absorbs the shorter shard)
        self.quarantine: set[int] = set()
        self.validate_layout = validate_layout
        self.crystal_slots = math.ceil(global_batch / num_devices)
        counts = ds.feature_counts()
        self.sampler = (LoadBalanceSampler(counts, seed) if load_balance
                        else DefaultSampler(counts, seed))

    def _caps_for(self, shards: list[np.ndarray]) -> BatchCapacities:
        if isinstance(self.caps, BatchCapacities):
            return self.caps
        na = nb = ng = 0
        for s in shards:
            na = max(na, sum(self.ds.crystals[i].num_atoms for i in s))
            nb = max(nb, sum(self.ds.graphs[i].num_bonds for i in s))
            ng = max(ng, sum(self.ds.graphs[i].num_angles for i in s))
        return self.caps.bucket_for(na, nb, ng)

    def add_quarantine(self, indices) -> None:
        """Exclude dataset indices from all future batches (the hook a
        quarantine feeds; the Trainer's ``on_quarantine``, which points
        here in the JAX package, comes with ROADMAP item 12)."""
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
            (shard,) = shards
            yield build_device_batch(
                self.ds, shard, self._caps_for(shards),
                num_crystal_slots=self.crystal_slots,
                validate=self.validate_layout)


class BalancedBatchIterator:
    """The cost-balanced microbatch iterator (DESIGN.md §6)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"BalancedBatchIterator {_TODO}")


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

    ``device=None`` yields the items as the source gives them.  A CUDA
    ``device`` needs CUDA (it raises without it, as the entry points do):
    the worker pins each item (a ``CrystalGraphBatch`` or a tensor) and
    copies it with ``non_blocking=True`` on a stream of its own, records
    an event after the copies and waits for it on its own thread, so the
    pinned source outlives its copies; the consumer's current stream
    waits on that event, and the item's memory is recorded on that stream
    so that the caching allocator does not reuse it while the consumer's
    work on it is queued.  Another device gets ``item.to(device)``.

    ``stats`` counts, in seconds: ``source_s``, the worker's time in the
    source (packing, for a ``BatchIterator``); ``copy_s``, its time
    pinning and copying; ``wait_s``, the consumer's time blocked on the
    queue; and ``items``, the items handed over.  The share of packing
    that the thread hides is ``1 - wait_s / (source_s + copy_s)``.
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
            return item.to(self.device)
        if not (torch.is_tensor(item) or isinstance(item, CrystalGraphBatch)):
            raise TypeError(f"Prefetcher copies CrystalGraphBatch or tensor "
                            f"items to {self.device}, got "
                            f"{type(item).__name__}")
        pinned = item.pin_memory()
        with torch.cuda.stream(self._stream):
            moved = pinned.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        # the pinned source must stay alive until its copies are done: wait
        # here, on the worker's thread, while the consumer's step runs
        ready.synchronize()
        return _OnDevice(moved, ready)

    def _worker(self):
        retries = 0
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
                if self.device is not None:
                    item = self._to_device(item)
                    self.stats["copy_s"] += clock() - t1
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
                    item.value.record_stream(stream)
                    item = item.value
                self.stats["items"] += 1
                yield item
            if self._error is not None:
                raise self._error
        finally:
            self.close()
