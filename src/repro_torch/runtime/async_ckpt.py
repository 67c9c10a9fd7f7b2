"""Asynchronous checkpoint writer, PyTorch port of
``repro.runtime.async_ckpt`` (DESIGN.md §8).

The step loop must not stall on serialization + fsync.  The split:

  - ``save(step, tree)`` runs on the CALLER thread and only snapshots the
    tree to host memory (``checkpoint.host_snapshot``: one device-to-host
    copy; always a copy, so Adam's later in-place updates cannot tear it);
  - MessagePack packing, the CRC32 manifest, the file write, fsync and
    pruning run on ONE background thread through the same
    :func:`checkpoint.save_checkpoint` as the sync path: async and sync
    files are byte-identical for identical state, and pruning cannot race
    another writer because there is only one.

The queue is bounded (default: one pending snapshot) and at most one
write is in flight; a ``save`` arriving while the queue is full blocks
the caller: backpressure instead of unbounded snapshot memory.  A worker
failure is captured and raised on the next ``save``/``flush``/``close``.
Every wait is bounded by ``TIMEOUT_S`` seconds (``TimeoutError`` past
it).  ``close`` is also registered atexit, so an exiting process flushes
any queued snapshot.
"""
from __future__ import annotations

import atexit
import logging
import queue
import threading
import time
from typing import Any

from .checkpoint import host_snapshot, save_checkpoint

log = logging.getLogger("repro_torch.ckpt")

# the longest any wait on the writer may take: a write of the state of a
# model this size takes well under a second
TIMEOUT_S = 600.0


class AsyncCheckpointWriter:
    def __init__(self, directory: str, *, keep: int = 3,
                 queue_depth: int = 1):
        self.directory = directory
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=max(1, queue_depth))
        # snapshots saved but not yet written (or failed), under _done
        self._pending = 0
        self._done = threading.Condition()
        self._error: BaseException | None = None
        self._closed = False
        self._last_written: int | None = None
        self._writes = 0
        self._thread = threading.Thread(
            target=self._worker, name="ckpt-writer", daemon=True)
        self._thread.start()
        atexit.register(self.close)

    # -- background side ----------------------------------------------------
    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree, extra_meta = item
            try:
                save_checkpoint(self.directory, step, tree,
                                keep=self.keep, extra_meta=extra_meta)
                self._last_written = step
                self._writes += 1
            except BaseException as exc:  # surfaced on the caller side
                log.error("async checkpoint write for step %s failed: %s",
                          step, exc)
                self._error = exc
            finally:
                with self._done:
                    self._pending -= 1
                    self._done.notify_all()

    # -- caller side --------------------------------------------------------
    def _raise_pending(self):
        if self._error is not None:
            exc, self._error = self._error, None
            raise RuntimeError(
                "async checkpoint write failed (state NOT durable past step "
                f"{self._last_written})") from exc

    def save(self, step: int, tree: Any, *,
             extra_meta: dict | None = None) -> None:
        """Snapshot now, write in the background.

        Blocks only when a previous snapshot is still queued (at-most-one
        pending; the in-flight write itself never blocks new saves).
        """
        self._raise_pending()
        if self._closed:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        item = (step, host_snapshot(tree), extra_meta)
        with self._done:
            self._pending += 1
        try:
            self._q.put(item, timeout=TIMEOUT_S)
        except queue.Full:
            with self._done:
                self._pending -= 1
            raise TimeoutError(
                f"checkpoint writer still busy after {TIMEOUT_S} s")

    def flush(self) -> None:
        """Block until every queued snapshot is durably written."""
        deadline = time.monotonic() + TIMEOUT_S
        with self._done:
            while self._pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{self._pending} checkpoint(s) not written after "
                        f"{TIMEOUT_S} s")
                self._done.wait(left)
        self._raise_pending()

    def close(self) -> None:
        """Flush queued writes and stop the worker (idempotent)."""
        if not self._closed:
            self._closed = True
            self._q.put(None, timeout=TIMEOUT_S)
            self._thread.join(TIMEOUT_S)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"checkpoint writer did not stop within {TIMEOUT_S} s")
            atexit.unregister(self.close)
        self._raise_pending()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()

    @property
    def last_written_step(self) -> int | None:
        return self._last_written

    @property
    def writes(self) -> int:
        return self._writes
