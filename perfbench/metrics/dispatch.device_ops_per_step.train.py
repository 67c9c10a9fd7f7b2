"""Device operations (kernels, copies, memsets) a traced step: what the
host dispatches through ``core/`` and the ``kernels/ops.py`` wrappers."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["trace"]["device"]:
        return None
    return len(t["trace"]["device"]) / len(t["rows"])
