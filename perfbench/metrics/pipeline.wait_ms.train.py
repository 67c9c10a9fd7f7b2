"""Milliseconds a step waits for its batch: the growth of the program's
``Prefetcher.stats["wait_s"]`` over the window, per step."""


def read(ctx):
    w = ctx["window"]
    return 1e3 * w["wait_s"] / len(w["rows"]) if w["rows"] else None
