"""Chaos harness: seeded, composable fault schedules (DESIGN.md §8),
PyTorch port of ``repro.runtime.chaos`` (the same grammar and kinds).

A :class:`ChaosSchedule` is a deterministic list of ``(step, kind, arg)``
events — parseable from a compact string for ``launch/train --chaos`` —
and a :class:`ChaosMonkey` drives it against a training run from two
hook points:

  - ``maybe_fail(step)`` (duck-types ``fault.FaultInjector``; plug it in
    as the Trainer's ``fault_injector``) fires step-loop faults:
    ``crash`` (RuntimeError), ``drop`` (DeviceLossError -> §6 elastic
    rebalance), ``sigterm`` (real signal to this process -> preemption
    path), ``straggler`` (injected sleep), ``ckpt_truncate`` /
    ``ckpt_bitflip`` (corrupt the newest checkpoint file on disk ->
    verified-restore fallback path);
  - ``wrap_batches(iterable)`` interposes on the data path: ``nan``
    (poison every float leaf of the step's batch -> divergence sentinel),
    ``transient`` (TransientSampleError -> Prefetcher retry/quarantine),
    ``prefetch_crash`` (RuntimeError from inside the producing iterator —
    wrapped under a Prefetcher it kills the worker thread).

Every event fires at most once per monkey, so a restarted loop sharing
the monkey replays cleanly; a fresh monkey with the same schedule + seed
reproduces the identical fault sequence (the determinism contract
``tests/test_torch_runtime.py`` asserts).  The wrapper stream is
resumable: raising does not poison it, so retry/restart paths can keep
pulling from the same object.

Spec grammar (comma-separated):  ``kind@step`` or ``kind@step:arg``
    e.g. ``nan@5,nan@6,sigterm@12,drop@7:0,straggler@9:0.2,ckpt_bitflip@20``
"""
from __future__ import annotations

import dataclasses
import logging
import os
import signal as _signal
import time

import numpy as np
import torch

from repro_torch.batching.balance import StepPlan
from repro_torch.core.graph import FIELDS, CrystalGraphBatch
from .checkpoint import _ckpt_path, list_checkpoints
from .fault import DeviceLossError, TransientSampleError

log = logging.getLogger("repro_torch.chaos")

STEP_KINDS = frozenset(
    {"crash", "drop", "sigterm", "straggler", "ckpt_truncate",
     "ckpt_bitflip"})
DATA_KINDS = frozenset({"nan", "transient", "prefetch_crash"})
KINDS = STEP_KINDS | DATA_KINDS


class ChaosError(RuntimeError):
    """An injected (non-transient) crash."""


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    step: int
    kind: str
    arg: float | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown chaos kind {self.kind!r}; know {sorted(KINDS)}")

    def spec(self) -> str:
        base = f"{self.kind}@{self.step}"
        return base if self.arg is None else f"{base}:{self.arg:g}"


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """An ordered, seeded fault schedule (composable: just concatenate
    event tuples).  ``seed`` feeds any randomized fault payloads (e.g.
    which bits a ``ckpt_bitflip`` flips), so the whole injected fault
    sequence is a pure function of (schedule, seed)."""

    events: tuple[ChaosEvent, ...] = ()
    seed: int = 0

    @classmethod
    def parse(cls, spec: str, *, seed: int = 0) -> "ChaosSchedule":
        events = []
        for token in filter(None, (t.strip() for t in spec.split(","))):
            try:
                kind, _, rest = token.partition("@")
                step_s, _, arg_s = rest.partition(":")
                events.append(ChaosEvent(
                    step=int(step_s), kind=kind,
                    arg=float(arg_s) if arg_s else None))
            except (ValueError, TypeError) as exc:
                raise ValueError(
                    f"bad chaos token {token!r} (want kind@step[:arg]): {exc}"
                ) from exc
        return cls(events=tuple(sorted(events, key=lambda e: e.step)),
                   seed=seed)

    def spec(self) -> str:
        return ",".join(e.spec() for e in self.events)

    def at(self, step: int, kinds: frozenset) -> list[ChaosEvent]:
        return [e for e in self.events
                if e.step == step and e.kind in kinds]


# ---------------------------------------------------------------------------
# file corruption primitives (also used directly by tests/benchmarks)
# ---------------------------------------------------------------------------

def truncate_file(path: str, keep_frac: float = 0.5) -> int:
    """Truncate to ``keep_frac`` of the current size (a torn write)."""
    size = os.path.getsize(path)
    keep = int(size * keep_frac)
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


def bitflip_file(path: str, *, seed: int = 0, nbits: int = 8) -> list[int]:
    """Flip ``nbits`` random bits in place (silent media corruption).
    Returns the flipped byte offsets."""
    size = os.path.getsize(path)
    rng = np.random.default_rng(seed)
    offsets = sorted(int(o) for o in rng.integers(0, size, size=nbits))
    with open(path, "r+b") as f:
        for off in offsets:
            f.seek(off)
            byte = f.read(1)[0]
            f.seek(off)
            f.write(bytes([byte ^ (1 << int(rng.integers(0, 8)))]))
    return offsets


def corrupt_newest_checkpoint(directory: str, mode: str = "truncate", *,
                              seed: int = 0) -> str | None:
    """Damage the newest checkpoint file; returns its path (None if no
    checkpoint exists yet)."""
    steps = list_checkpoints(directory)
    if not steps:
        return None
    path = _ckpt_path(directory, steps[-1])
    if mode == "truncate":
        truncate_file(path)
    elif mode == "bitflip":
        bitflip_file(path, seed=seed)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    log.warning("chaos: corrupted checkpoint %s (%s)", path, mode)
    return path


def poison_nan(item):
    """NaN-fill every float field of a batch, a TaggedBatch's batch or each
    of a StepPlan's microbatches (the indices stay)."""
    from repro_torch.data.pipeline import TaggedBatch

    if isinstance(item, TaggedBatch):
        return TaggedBatch(item.indices, poison_nan(item.batch))
    if isinstance(item, StepPlan):
        return dataclasses.replace(
            item, micro=[poison_nan(m) for m in item.micro])
    if torch.is_tensor(item):
        return torch.full_like(item, float("nan")) \
            if item.is_floating_point() else item
    if isinstance(item, CrystalGraphBatch):
        return CrystalGraphBatch(**{k: poison_nan(getattr(item, k))
                                    for k in FIELDS})
    raise TypeError(f"cannot poison {type(item).__name__}")


# ---------------------------------------------------------------------------
# the monkey
# ---------------------------------------------------------------------------

class ChaosMonkey:
    """Drives a :class:`ChaosSchedule` against a run (see module docs).

    ``fired`` persists across loop restarts sharing this monkey, so each
    event is injected exactly once; ``log_events`` records what actually
    fired, in order, for bench/test assertions.
    """

    def __init__(self, schedule: ChaosSchedule, *,
                 ckpt_dir: str | None = None):
        self.schedule = schedule
        self.ckpt_dir = ckpt_dir
        self.fired: set[tuple[int, str]] = set()
        self.log_events: list[tuple[str, int]] = []

    def _fire(self, ev: ChaosEvent) -> bool:
        key = (ev.step, ev.kind)
        if key in self.fired:
            return False
        self.fired.add(key)
        self.log_events.append((ev.kind, ev.step))
        log.warning("chaos: firing %s at step %d", ev.kind, ev.step)
        return True

    # FaultInjector duck type: called by the Trainer loop before each step
    def maybe_fail(self, step: int):
        for ev in self.schedule.at(step, STEP_KINDS):
            if not self._fire(ev):
                continue
            if ev.kind == "crash":
                raise ChaosError(f"injected step-loop crash at step {step}")
            if ev.kind == "drop":
                raise DeviceLossError(
                    int(ev.arg or 0), f"injected device drop at step {step}")
            if ev.kind == "sigterm":
                os.kill(os.getpid(), _signal.SIGTERM)
            elif ev.kind == "straggler":
                time.sleep(float(ev.arg) if ev.arg is not None else 0.25)
            elif ev.kind in ("ckpt_truncate", "ckpt_bitflip"):
                if self.ckpt_dir is not None:
                    corrupt_newest_checkpoint(
                        self.ckpt_dir, mode=ev.kind.removeprefix("ckpt_"),
                        seed=self.schedule.seed)

    def wrap_batches(self, iterable, *, start_step: int = 0):
        """Interpose the data-path faults on a batch stream.

        The returned iterator is RESUMABLE (a class, not a generator):
        after it raises ``transient``/``prefetch_crash``, the next
        ``__next__`` continues with the following step's batch — the
        contract the Prefetcher's retry path needs.  ``start_step``
        aligns the event counter with ``Trainer.step`` on resume.
        """
        return _ChaosBatchStream(self, iterable, start_step)


class _ChaosBatchStream:
    def __init__(self, monkey: ChaosMonkey, iterable, start_step: int):
        self._monkey = monkey
        self._it = iter(iterable)
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self._it)
        step = self.step
        # advance BEFORE raising: a retry must move on to the next step's
        # batch (the faulted one is consumed == quarantined), not refetch
        self.step += 1
        for ev in self._monkey.schedule.at(step, DATA_KINDS):
            if not self._monkey._fire(ev):
                continue
            if ev.kind == "nan":
                item = poison_nan(item)
            elif ev.kind == "transient":
                raise TransientSampleError(
                    index=step, msg=f"injected transient fault at step {step}")
            elif ev.kind == "prefetch_crash":
                raise ChaosError(f"injected prefetch crash at step {step}")
        return item
