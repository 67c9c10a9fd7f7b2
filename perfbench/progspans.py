"""The program's own spans of the traced steps, for the metrics that
read them.

The port's recorder (``repro_torch.runtime.trace``) keeps spans only
while a profiler runs on the thread that steps, so after a traced run it
holds the traced steps' spans (``trainer.step`` and, inside it,
``trainer.forward``, ``trainer.backward``, ``trainer.optimizer``,
``trainer.read``) and the prefetch worker's around them
(``prefetch.pack``, ``prefetch.copy``), on ``time.perf_counter``'s
clock.  The step spans are also in the profiler's trace, and map the
worker's spans onto its clock.  A program without the recorder, or a run
without a trace, gives None, and so does every reader.
"""
from __future__ import annotations

import numpy as np

from perfbench import devtrace

STEP = "trainer.step"
WORKER = ("prefetch.pack", "prefetch.copy")
# the most the median traced step's start may lie off the line that maps
# one clock onto the other, in us
MAX_SKEW_US = 50.0
# the most by which the two clocks' rates may differ
MAX_DRIFT = 1e-3


def records(ctx) -> list | None:
    """The recorder's spans of the traced run ``ctx``, or None."""
    if ctx["trace"] is None:
        return None
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    return trace.spans() or None


def _steps(recs: list) -> list:
    return sorted((r for r in recs if r.name == STEP), key=lambda r: r.start)


def per_step_ms(ctx, name: str) -> float | None:
    """Milliseconds of span ``name`` on the stepping thread, summed over
    the traced steps and divided by their number."""
    recs = records(ctx)
    steps = _steps(recs) if recs else []
    if not steps:
        return None
    lo, hi, thread = steps[0].start, steps[-1].end, steps[0].thread
    mine = [r.end - r.start for r in recs if r.name == name
            and r.thread == thread and lo <= r.start <= hi]
    return 1e3 * sum(mine) / len(steps) if mine else None


def worker_ms(ctx, name: str) -> float | None:
    """Mean milliseconds of the worker's span ``name`` over those that
    start between the first traced step's start and the last one's
    end."""
    recs = records(ctx)
    steps = _steps(recs) if recs else []
    if not steps:
        return None
    lo, hi = steps[0].start, steps[-1].end
    mine = [r.end - r.start for r in recs
            if r.name == name and lo <= r.start <= hi]
    return 1e3 * float(np.mean(mine)) if mine else None


def clock_map(trace: dict, recs: list):
    """The recorder's clock (s) onto the profiler's (us): the line through
    the traced ``trainer.step`` starts, in both clocks, by medians (the
    slope of every pair of steps, then the offset), since the clocks
    drift apart by some us a second and a step's two clock reads may lie
    a GIL hand-over apart.  None where the two hold different numbers of
    steps, their rates differ by more than ``MAX_DRIFT``, or the median
    step lies more than ``MAX_SKEW_US`` off the line."""
    prof = np.array(sorted(s for n, s, _ in trace["host"] if n == STEP))
    rec = np.array([r.start for r in _steps(recs)])
    if not len(rec) or len(rec) != len(prof):
        return None
    x0, y0 = rec[0], prof[0]
    x, y = rec - x0, prof - y0
    i, j = np.triu_indices(len(x), 1)
    ok = x[j] > x[i]
    rate = float(np.median((y[j] - y[i])[ok] / (x[j] - x[i])[ok])) \
        if ok.any() else 1e6
    if abs(rate / 1e6 - 1.0) > MAX_DRIFT:
        return None
    off = float(np.median(y - x * rate))
    if np.median(np.abs(y - x * rate - off)) > MAX_SKEW_US:
        return None
    return lambda t: y0 + off + (t - x0) * rate


def idle_worker_share(ctx) -> float | None:
    """Percent of the device's idle time in the traced window during
    which the prefetch worker was packing or copying."""
    t = ctx["trace"]
    if t is None or not t["trace"]["device"]:
        return None
    recs = records(ctx)
    to_prof = clock_map(t["trace"], recs) if recs else None
    if to_prof is None:
        return None
    gaps = np.array(devtrace.gaps(t["trace"]), float).reshape(-1, 2)
    idle = float((gaps[:, 1] - gaps[:, 0]).sum())
    if idle <= 0:
        return None
    busy = devtrace.merge((to_prof(r.start), to_prof(r.end))
                          for r in recs if r.name in WORKER)
    inside = sum(float(np.clip(np.minimum(gaps[:, 1], e)
                               - np.maximum(gaps[:, 0], s), 0, None).sum())
                 for s, e in busy)
    return 100.0 * inside / idle
