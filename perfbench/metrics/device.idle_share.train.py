"""Share of the traced window in which no operation ran on the card."""
from perfbench import devtrace


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["trace"]["device"]:
        return None
    lo, hi = t["trace"]["window"]
    return 100.0 * (1.0 - devtrace.busy_us(t["trace"]) / (hi - lo))
