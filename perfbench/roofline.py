"""A kernel's share of its roofline over the traced steps.

Sum of the launches' bounds over the sum of their measured times.  A
launch's bound is the larger of its operations over the peak (split-f32
kernels: SPLIT TF32 products per f32 product at the TF32 peak) and its
bytes over the memory bandwidth, at the real rows of its step (the
kernel's file under ``kernels/`` counts both).
"""
from __future__ import annotations

import re
import sys


def share(ctx: dict, kernel: str):
    """Percent, or None where the trace holds no launch of ``kernel``, or
    where the launches traced in some mode are not those counted."""
    trace, peaks = ctx["trace"], ctx["peaks"]
    if trace is None or peaks is None:
        return None
    spec = ctx["kernels"](kernel)
    pattern = re.compile(spec.PATTERN)
    measured, seen = 0.0, {}
    for name, s, e in trace["trace"]["device"]:
        m = pattern.search(name)
        if m:
            measured += (e - s) * 1e-6
            mode = m.group(1) if m.groups() else ""
            seen[mode] = seen.get(mode, 0) + 1
    if not seen:
        return None
    bound, expected = 0.0, {}
    for rows in trace["rows"]:
        for launch in spec.launches(ctx["model"], rows):
            bound += max(spec.SPLIT * launch["flops"] / peaks["tf32_flops"],
                         launch["bytes"] / peaks["hbm_bytes_per_s"])
            expected[launch["mode"]] = expected.get(launch["mode"], 0) + 1
    if seen != expected:
        # the bound would cover other launches than the time: no share
        print(f"perfbench: {kernel}: {seen} launches traced, {expected} "
              "counted; the share is left out", file=sys.stderr)
        return None
    return 100.0 * bound / measured
