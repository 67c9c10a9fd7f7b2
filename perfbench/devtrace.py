"""Reduction of a ``torch.profiler`` trace of the traced steps.

The device's operations (kernels, copies, memsets) and the benchmark's
own host spans (``perfbench.wait``: blocked on the prefetcher's queue;
``perfbench.step``: inside ``Trainer.train``) share the profiler's clock,
in microseconds.  The traced window runs from the first span's start to
the last span's end.
"""
from __future__ import annotations

import collections

import numpy as np

# gaps labelled by the host operation that covers them
LABELLED = 256


def collect(prof) -> dict:
    """Device operations and host spans of a finished profiler."""
    device, host, spans = [], [], []
    for ev in prof.events():
        kind = getattr(ev.device_type, "name", str(ev.device_type))
        start, end = ev.time_range.start, ev.time_range.end
        if kind == "CUDA":
            # the profiler mirrors each host span on the device as an
            # annotation: not an operation
            if not (ev.name.startswith("perfbench.")
                    or getattr(ev, "is_user_annotation", False)):
                device.append((ev.name, start, end))
        elif ev.name.startswith("perfbench."):
            spans.append((ev.name, start, end, ev.thread))
        else:
            host.append((ev.name, start, end, ev.thread))
    # the host operations of the thread that runs the steps
    main = {t for *_, t in spans}
    host = [h[:3] for h in host if h[3] in main]
    spans = [s[:3] for s in spans]
    if not spans:
        return {"device": [], "host": [], "spans": [], "window": None}
    lo = min(s for _, s, _ in spans)
    hi = max(e for _, _, e in spans)
    return {"device": [d for d in device if d[1] < hi and d[2] > lo],
            "host": host, "spans": spans, "window": (lo, hi)}


def merge(intervals) -> list[tuple[float, float]]:
    """Union of (start, end) intervals, sorted."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(trace: dict) -> float:
    lo, hi = trace["window"]
    return sum(min(e, hi) - max(s, lo)
               for s, e in merge((s, e) for _, s, e in trace["device"]))


def gaps(trace: dict) -> list[tuple[float, float]]:
    """Idle stretches of the device inside the traced window."""
    lo, hi = trace["window"]
    out, t = [], lo
    for s, e in merge((s, e) for _, s, e in trace["device"]):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def _labeller(trace: dict):
    """What the host did in a gap: the benchmark's span that covers it
    most, and the host operation that covers it most (of those, the
    shortest: the innermost)."""
    def table(events):
        names = [n for n, _, _ in events]
        se = np.array([(a, b) for _, a, b in events], float).reshape(-1, 2)
        return names, se[:, 0], se[:, 1]

    tables = [table(trace["spans"]), table(trace["host"])]

    def best(tab, s, e):
        names, a, b = tab
        cover = np.minimum(b, e) - np.maximum(a, s)
        if not cover.size or cover.max() <= 0:
            return None
        tie = np.nonzero(cover >= cover.max())[0]
        return names[tie[np.argmin((b - a)[tie])]]

    def label(s, e):
        span = best(tables[0], s, e) or "outside a step"
        span = {"perfbench.wait": "waiting for a batch",
                "perfbench.step": "inside Trainer.train"}.get(span, span)
        op = best(tables[1], s, e)
        return span if op is None else f"{span}: {op}"

    return label


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by
    what the host was doing, each as [name, seconds], longest first."""
    ops = collections.Counter()
    for name, s, e in trace["device"]:
        ops[name] += (e - s) * 1e-6
    idle = collections.Counter()
    label = _labeller(trace)
    # the longest gaps are labelled one by one, the rest by the span only
    spans_only = dict(trace, host=[])
    short = _labeller(spans_only)
    for k, (s, e) in enumerate(sorted(gaps(trace),
                                      key=lambda g: g[0] - g[1])):
        idle[(label if k < LABELLED else short)(s, e)] += (e - s) * 1e-6
    return {"device_ops": [[n, t] for n, t in ops.most_common(top)],
            "idle_gaps": [[n, t] for n, t in idle.most_common(top)]}
