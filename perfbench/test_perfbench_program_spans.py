"""The readers of the program's spans (``progspans`` and the seven
metrics on it): on hand-made recorder records and a synthetic profiler
trace, and in a traced CPU run of a cell."""
import io
import json
from typing import NamedTuple

import pytest

from perfbench import harness, progspans

METRICS = harness.BENCH / "metrics"
STEP_METRICS = {"step.forward_ms.train": "trainer.forward",
                "step.backward_ms.train": "trainer.backward",
                "step.optimizer_ms.train": "trainer.optimizer",
                "step.read_ms.train": "trainer.read"}
NEW = [*STEP_METRICS, "pipeline.pack_ms.train", "pipeline.copy_ms.train",
       "device.idle_packing_share.train"]
MAIN, WORKER = 1, 2
STEPS = (10.0, 10.1, 10.2)
# idle: 5 us before the first step, then the second half of each step
IDLE = 5.0 + 50000.0 + 50000.0 + 50005.0


class Span(NamedTuple):
    name: str
    thread: int
    start: float
    end: float
    ordinal: int


def _records():
    """Three steps of 100 ms from t = 10 s on the recorder's clock, their
    inner spans, an eval forward before them, a span of another thread,
    and worker spans before, during and after the steps."""
    recs = []
    for k, t in enumerate(STEPS):
        recs.append(Span("trainer.step", MAIN, t, t + 0.1, k))
        for name, a, b in (("trainer.forward", 0.001, 0.041),
                           ("trainer.backward", 0.041, 0.071),
                           ("trainer.optimizer", 0.071, 0.081),
                           ("trainer.read", 0.081, 0.099)):
            recs.append(Span(name, MAIN, t + a, t + b, k))
    recs.append(Span("trainer.forward", MAIN, 9.5, 9.6, 0))
    recs.append(Span("trainer.forward", 3, 10.05, 10.15, 0))
    recs += [Span("prefetch.pack", WORKER, 9.95, 9.99, 0),
             Span("prefetch.copy", WORKER, 9.99, 9.995, 0),
             Span("prefetch.pack", WORKER, 10.06, 10.09, 1),
             Span("prefetch.copy", WORKER, 10.09, 10.092, 1),
             Span("prefetch.pack", WORKER, 10.12, 10.13, 2),
             Span("prefetch.copy", WORKER, 10.13, 10.134, 2),
             Span("prefetch.pack", WORKER, 10.35, 10.45, 3)]
    return recs


def _ctx(late_us=(0.0, 0.0, 0.0), device=True):
    """A traced run's context on the profiler's clock (us), whose zero is
    the recorder's 9.999 s: the steps as host events, each ``late_us``
    late; the card busy in the first half of each step."""
    host = [("trainer.step", 1000.0 + 1e5 * k + d, 101000.0 + 1e5 * k)
            for k, d in enumerate(late_us)] + [("aten::add", 2000., 2100.)]
    dev = [("k", 1000.0 + 1e5 * k, 51000.0 + 1e5 * k) for k in range(3)] \
        if device else []
    trace = {"device": dev, "host": host,
             "spans": [("perfbench.step", 995.0, 301005.0)],
             "window": (995.0, 301005.0)}
    return {"trace": {"trace": trace, "rows": [{}, {}, {}]}}


def _read(name, ctx):
    return harness.load_file(METRICS / f"{name}.py").read(ctx)


@pytest.fixture
def recorded(monkeypatch):
    recs = _records()
    monkeypatch.setattr(progspans, "records",
                        lambda ctx: recs if ctx["trace"] else None)
    return recs


@pytest.mark.parametrize("name,want", [
    ("step.forward_ms.train", 40.0), ("step.backward_ms.train", 30.0),
    ("step.optimizer_ms.train", 10.0), ("step.read_ms.train", 18.0)])
def test_step_ms_per_traced_step(recorded, name, want):
    """The stepping thread's spans inside the traced steps, per step:
    the eval forward before them and another thread's are left out."""
    assert _read(name, _ctx()) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name,want", [
    ("pipeline.pack_ms.train", (30.0 + 10.0) / 2),
    ("pipeline.copy_ms.train", (2.0 + 4.0) / 2)])
def test_worker_ms_clipped_to_the_traced_steps(recorded, name, want):
    assert _read(name, _ctx()) == pytest.approx(want, rel=1e-9)


def test_idle_packing_share_on_the_mapped_clock(recorded):
    """The worker's spans of item 1 (32 ms) fall in the first step's idle
    half; item 2's while the card is busy; items 0 and 3 outside the
    window."""
    share = "device.idle_packing_share.train"
    assert _read(share, _ctx()) == pytest.approx(100 * 32000 / IDLE,
                                                 rel=1e-9)
    to_prof = progspans.clock_map(_ctx()["trace"]["trace"], recorded)
    assert to_prof(10.06) == pytest.approx(61000.0)
    # clocks that drift apart by 200 us a second map along the line
    drift = _ctx(late_us=(0.0, 20.0, 40.0))
    to_prof = progspans.clock_map(drift["trace"]["trace"], recorded)
    assert to_prof(10.2) == pytest.approx(201040.0)
    assert _read(share, drift) == pytest.approx(100 * 32006.4 / IDLE,
                                                rel=1e-6)
    # one step whose two clock reads lie a GIL hand-over apart is
    # outvoted
    assert _read(share, _ctx(late_us=(0.0, 500.0, 0.0))) == \
        pytest.approx(100 * 32000 / IDLE, rel=1e-9)


def _steps_clock_map(late_us, rate=1.0):
    """``clock_map`` of steps 100 ms apart from t = 10 s, the profiler's
    starts ``late_us`` late and its clock running ``rate`` times as fast."""
    recs = [Span("trainer.step", MAIN, 10 + 0.1 * k, 10.1 + 0.1 * k, k)
            for k in range(len(late_us))]
    host = [("trainer.step", 1000.0 + 1e5 * k * rate + d, 0.0)
            for k, d in enumerate(late_us)]
    return progspans.clock_map({"host": host}, recs)


@pytest.mark.parametrize("late_us", [(500, 0, 0, 0, 0, 0),
                                     (0, 0, 0, 0, 0, 500),
                                     (0, -40, 40, -40, 40, 0)])
def test_clock_map_outvotes_a_stray_step(late_us):
    to_prof = _steps_clock_map(late_us)
    assert abs(to_prof(10.0) - 1000.0) <= 40.0
    assert abs(to_prof(10.5) - 501000.0) <= 40.0


@pytest.mark.parametrize("late_us,rate", [
    ((0, 120, -120, 120, -120, 0), 1.0), ((0, 200, -200, 200, -200, 200), 1.0),
    ((0, 0, 0), 1.002), ((0, 0, 0), 2.0)],
    ids=["jitter", "jitter-most", "drift", "rate"])
def test_clock_map_refuses_clocks_that_disagree(recorded, late_us, rate):
    """None where most steps lie more than 50 us off the line, or the
    clocks' rates differ by more than 1e-3; then the share is None."""
    assert _steps_clock_map(late_us, rate) is None
    if len(late_us) == 3:
        ctx = _ctx()
        for k, (n, s, e) in enumerate(ctx["trace"]["trace"]["host"][:3]):
            ctx["trace"]["trace"]["host"][k] = (n, 1000 + (s - 1000) * rate,
                                                e)
        assert _read("device.idle_packing_share.train", ctx) is None


def test_idle_packing_share_needs_every_step_in_both(recorded):
    ctx = _ctx()
    ctx["trace"]["trace"]["host"].pop(1)
    assert _read("device.idle_packing_share.train", ctx) is None


def test_none_without_spans_trace_or_device(recorded, monkeypatch):
    assert _read("device.idle_packing_share.train",
                 _ctx(device=False)) is None
    untraced = {"trace": None}
    for name in NEW:
        assert _read(name, untraced) is None
    monkeypatch.setattr(progspans, "records", lambda ctx: None)
    for name in NEW:
        assert _read(name, _ctx()) is None


def test_records_none_without_the_recorder(monkeypatch):
    """A program without ``repro_torch.runtime.trace`` (the import fails)
    gives None."""
    import builtins

    real = builtins.__import__

    def no_trace(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "repro_torch.runtime" and "trace" in (fromlist or ()):
            raise ImportError("no recorder")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    assert progspans.records(_ctx()) is None


def test_traced_cpu_run_reports_the_spans_metrics(tiny):
    """A traced CPU run reports the five metrics a CPU gives: no copy to
    a card and no device events, so no copy ms and no idle share."""
    spec = tiny("fastchgnet.mptrj_b128")
    out, err = io.StringIO(), io.StringIO()
    res = harness.run(spec, 2**31 + 11, 0.2, True, device="cpu")
    harness.emit(res, out, err)
    got = json.loads(out.getvalue().strip().splitlines()[-1])["metrics"]
    five = {*STEP_METRICS, "pipeline.pack_ms.train"}
    assert five <= set(got)
    assert not {"pipeline.copy_ms.train",
                "device.idle_packing_share.train"} & set(got)
    for name in five:
        assert got[name]["unit"] == "ms" and got[name]["value"] > 0
