"""Fault tolerance, PyTorch port of ``repro.runtime.fault``: restart
orchestration, divergence and preemption detection, straggler watch
(DESIGN.md §8).  Plain Python and numpy, as in the JAX package.

``run_with_restarts`` wraps a training loop: on a *retryable* exception
(an infra flake, an OOM, an injected fault) it resumes from the newest
valid checkpoint, up to ``max_restarts``.  Programming errors (TypeError,
ValueError, missing attributes/keys ...) and graceful preemption
(:class:`PreemptionError`) fail fast.

``DivergenceSentinel`` is the Trainer's loss-blow-up detector: a streak of
non-finite losses or of spikes far above the trailing median trips a
rollback to the last good checkpoint.  Steps the §4 loss scaler already
rejected (``grads_finite == 0``) are exempt.

``GracefulShutdown`` + the resume-marker helpers implement preemption:
SIGTERM flips a flag, the Trainer writes a final checkpoint plus a
``RESUME.json`` marker and raises :class:`PreemptionError`; the next
launch resumes from that exact step.

``StragglerWatch`` flags a step slower than ``threshold`` x the trailing
median.  ``TransientSampleError`` is the exception the ``Prefetcher``
retries and quarantines.  ``DeviceLossError`` and ``DeviceDropInjector``
are the types of a lost device, which ``elastic.elastic_train`` catches.
"""
from __future__ import annotations

import json
import logging
import math
import os
import signal as _signal
import time
from collections import deque
from typing import Any, Callable

import numpy as np

log = logging.getLogger("repro_torch.fault")

RESUME_MARKER = "RESUME.json"


class StragglerWatch:
    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.times: list[float] = []
        self.window = window
        self.threshold = threshold
        self.flags = 0

    def record(self, seconds: float) -> bool:
        """Record one step; returns True if it is a straggler step."""
        self.times.append(seconds)
        hist = self.times[-self.window:]
        if len(hist) < 8:
            return False
        med = float(np.median(hist))
        is_slow = seconds > self.threshold * med
        if is_slow:
            self.flags += 1
        return is_slow


class DivergenceSentinel:
    """Loss-spike / NaN-streak detector driving checkpoint rollback.

    ``record(loss, scaler_skipped=...)`` returns True when the run should
    roll back:

      - ``nan_streak`` consecutive non-finite losses, or
      - ``spike_streak`` consecutive losses above ``spike_factor`` x the
        median of the trailing ``window`` HEALTHY losses (spikes are never
        admitted into the reference window, so a blow-up can't drag the
        median up after itself).

    ``scaler_skipped`` steps (the §4 dynamic loss scaler rejected the
    update on an inf/nan gradient) are exempt: params were not touched,
    and scaler backoff is the correct response, not rollback.  A trip
    resets both streaks; ``last_trip_len`` reports how many steps the
    tripping streak spanned (the quarantine window).
    """

    def __init__(self, *, window: int = 32, nan_streak: int = 2,
                 spike_factor: float = 10.0, spike_streak: int = 4,
                 min_history: int = 8):
        self.window = window
        self.nan_streak = max(1, nan_streak)
        self.spike_factor = spike_factor
        self.spike_streak = max(1, spike_streak)
        self.min_history = min_history
        self.losses: deque[float] = deque(maxlen=window)
        self.nan_run = 0
        self.spike_run = 0
        self.trips = 0
        self.last_trip_len = 0

    @property
    def suspicious(self) -> bool:
        """A streak is building: the current params may be poisoned, so
        periodic checkpoints should be withheld until it clears."""
        return self.nan_run > 0 or self.spike_run > 0

    def record(self, loss: float, *, scaler_skipped: bool = False) -> bool:
        if scaler_skipped:
            return False  # rejected update: params untouched (DESIGN.md §4)
        if not math.isfinite(loss):
            self.nan_run += 1
            self.spike_run = 0
        else:
            self.nan_run = 0
            med = (float(np.median(self.losses))
                   if len(self.losses) >= self.min_history else None)
            if med is not None and loss > self.spike_factor * max(med, 1e-12):
                self.spike_run += 1
            else:
                self.spike_run = 0
                self.losses.append(loss)
        if (self.nan_run >= self.nan_streak
                or self.spike_run >= self.spike_streak):
            self.last_trip_len = max(self.nan_run, self.spike_run)
            self.trips += 1
            self.nan_run = self.spike_run = 0
            return True
        return False


class FaultInjector:
    """Deterministic fault injection for tests: raises at given steps."""

    def __init__(self, fail_at_steps: set[int]):
        self.fail_at = set(fail_at_steps)
        self.fired: set[int] = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected fault at step {step}")


class TransientSampleError(RuntimeError):
    """A transiently-bad sample/batch fetch in the data pipeline.

    Carries the offending index so ``data.pipeline.Prefetcher`` can
    quarantine it (log + skip, bounded retry-with-backoff) instead of
    killing the run.  Raisers must leave their iterator resumable — the
    retry re-enters ``__next__`` on the same object.
    """

    def __init__(self, index: int | None = None, msg: str | None = None):
        super().__init__(msg or f"transient sample failure (index={index})")
        self.index = index


class DeviceLossError(RuntimeError):
    """A device dropped out of the mesh mid-run (DESIGN.md §6).

    Carries which mesh position failed, for the elastic path that rebuilds
    the mesh from the survivors (``elastic.elastic_train``).  On one
    device nothing catches it.
    """

    def __init__(self, failed_index: int, msg: str | None = None):
        super().__init__(msg or f"device {failed_index} lost")
        self.failed_index = failed_index


class DeviceDropInjector:
    """Deterministic device-loss injection (duck-types FaultInjector).

    Raises :class:`DeviceLossError` once at ``fail_at_step``, naming
    ``device_index`` as the lost mesh position.  It fires by step, so the
    injectors of every rank of a mesh fire at the same step.
    """

    def __init__(self, fail_at_step: int, device_index: int = 0):
        self.fail_at = fail_at_step
        self.device_index = device_index
        self.fired = False

    def maybe_fail(self, step: int):
        if not self.fired and step == self.fail_at:
            self.fired = True
            raise DeviceLossError(
                self.device_index,
                f"injected loss of device {self.device_index} "
                f"at step {step}")


# ---------------------------------------------------------------------------
# Preemption (SIGTERM) handling
# ---------------------------------------------------------------------------

class PreemptionError(RuntimeError):
    """Graceful shutdown: a final checkpoint + resume marker were written
    and the process should exit NOW.  Never retried by
    ``run_with_restarts`` — the scheduler restarts the job, not us."""

    def __init__(self, step: int, msg: str | None = None):
        super().__init__(msg or f"preempted at step {step}")
        self.step = step


class GracefulShutdown:
    """Signal-to-flag preemption latch.

    ``install()`` registers handlers (default: SIGTERM) that only set
    ``requested`` — async-signal-safe, no work in the handler.  The
    Trainer polls the flag between steps, writes a final checkpoint and
    a resume marker, and raises :class:`PreemptionError`.  Usable as a
    context manager; ``uninstall()`` restores the previous handlers.
    """

    def __init__(self, signals: tuple = (_signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.requested = False
        self.signum: int | None = None
        self._old: dict = {}

    def _handler(self, signum, frame):
        self.requested = True
        self.signum = signum

    def install(self) -> "GracefulShutdown":
        for s in self.signals:
            self._old[s] = _signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        for s, old in self._old.items():
            _signal.signal(s, old)
        self._old.clear()

    def __enter__(self) -> "GracefulShutdown":
        return self.install()

    def __exit__(self, *exc_info) -> None:
        self.uninstall()


def write_resume_marker(directory: str, step: int, *,
                        reason: str = "preempt") -> str:
    """Atomically drop ``RESUME.json`` next to the checkpoints."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, RESUME_MARKER)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, "reason": reason, "time": time.time()}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_resume_marker(directory: str) -> dict | None:
    path = os.path.join(directory, RESUME_MARKER)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def clear_resume_marker(directory: str) -> None:
    try:
        os.remove(os.path.join(directory, RESUME_MARKER))
    except OSError:
        pass


# ---------------------------------------------------------------------------
# Restart orchestration
# ---------------------------------------------------------------------------

# Exceptions restarting can never fix: programming/configuration errors
# (the same code re-raises them deterministically) and graceful
# preemption (the scheduler owns the restart).  Everything else — infra
# flakes, injected faults, OOMs surfacing as RuntimeError — is retryable.
NON_RETRYABLE = (
    TypeError, ValueError, KeyError, IndexError, AttributeError,
    NameError, ImportError, NotImplementedError, AssertionError,
    PreemptionError,
)


def run_with_restarts(
    loop_fn: Callable[[int], Any],
    *,
    resume_step_fn: Callable[[], int],
    max_restarts: int = 3,
    retryable: Callable[[BaseException], bool] | None = None,
) -> Any:
    """Run loop_fn(start_step); on retryable failure, resume from the last
    checkpoint.

    loop_fn must be restartable from any checkpointed step (pure training
    state lives in checkpoints, not Python locals).  ``retryable`` is an
    optional predicate overriding the default policy (retry everything
    except :data:`NON_RETRYABLE`); note ``DeviceLossError`` is a
    RuntimeError and therefore retryable here.
    """
    def _should_retry(exc: BaseException) -> bool:
        if retryable is not None:
            return retryable(exc)
        return not isinstance(exc, NON_RETRYABLE)

    restarts = 0
    while True:
        start = resume_step_fn()
        try:
            return loop_fn(start)
        except Exception as exc:
            if not _should_retry(exc):
                log.error("non-retryable failure (%s: %s); failing fast",
                          type(exc).__name__, exc)
                raise
            restarts += 1
            if restarts > max_restarts:
                log.error("exceeded max_restarts=%d, giving up", max_restarts)
                raise
            log.warning(
                "step loop failed (%s); restart %d/%d from step %d",
                exc, restarts, max_restarts, resume_step_fn(),
            )
            time.sleep(0.05)
