"""The port's span recorder (``repro_torch.runtime.trace``) on the CPU: a
small Trainer fed by ``Prefetcher(BatchIterator(...))`` records nothing
and enters no ``record_function`` without a profiler; under one, each
step's ``trainer.step`` holds its forward, backward, optimizer and read
in that order, the worker records one ``prefetch.pack`` per batch, and
the step spans reach the profiler's events; the parameters are the same
bit for bit either way; the buffer is bounded and a new session clears
it."""
from __future__ import annotations

import itertools
import threading

import pytest
import torch

from repro_torch.batching import ladder_for
from repro_torch.configs import chgnet_mptrj
from repro_torch.data import (BalancedBatchIterator, BatchIterator,
                              Prefetcher, SyntheticConfig, make_dataset)
from repro_torch.optim.tree import leaves
from repro_torch.runtime import trace
from repro_torch.train.trainer import TrainConfig, Trainer

STEPS = 3
INNER = ["trainer.forward", "trainer.backward", "trainer.optimizer",
         "trainer.read"]
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module")
def ds():
    return make_dataset(SyntheticConfig(num_crystals=32, max_atoms=12,
                                        seed=0))


def _trainer():
    cfg = chgnet_mptrj.FAST_FS_HEAD.with_(dim=16, num_blocks=1, num_rbf=7,
                                          num_fourier=7)
    return Trainer(cfg, TrainConfig(global_batch=4), seed=0, device="cpu")


def _train(ds, tr, plans=False):
    """``STEPS`` steps of ``tr`` through a Prefetcher, closed after."""
    it = (BalancedBatchIterator(ds, 4, 1, ladder_for(ds, 4), num_micro=2,
                                seed=1) if plans
          else BatchIterator(ds, 4, 1, ladder_for(ds, 4), seed=1))
    pf = Prefetcher(it, depth=2)
    try:
        return tr.train(itertools.islice(pf, STEPS))
    finally:
        pf.close()
        assert not pf.thread.is_alive()


def test_no_profiler_records_nothing(ds, monkeypatch):
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or real(name))
    # a session left on by an earlier profiled run ends at the next step
    assert trace.follow_profiler() is False
    before = trace.spans()
    hist = _train(ds, _trainer())
    assert len(hist) == STEPS
    assert trace.spans() == before and not trace.on()
    assert entered == []


@pytest.mark.parametrize("plans", [False, True], ids=["batch", "plan"])
def test_profiled_steps_record_nested_spans(ds, plans):
    tr = _trainer()
    # off, as after an untraced step; on again before the worker starts,
    # so that every batch's packing is in the new session
    trace.follow_profiler()
    with torch.profiler.profile(activities=CPU) as prof:
        assert trace.follow_profiler() is True
        _train(ds, tr, plans)
    recs = trace.spans()
    main = threading.get_ident()
    steps = [r for r in recs if r.name == "trainer.step"]
    assert [s.ordinal for s in steps] == list(range(STEPS))
    assert {s.thread for s in steps} == {main}
    micro = 2 if plans else 1
    for s in steps:
        inner = sorted((r for r in recs if r.thread == main
                        and r.name != "trainer.step"
                        and r.ordinal == s.ordinal), key=lambda r: r.start)
        want = (["trainer.forward", "trainer.backward"] * micro
                + ["trainer.optimizer", "trainer.read"])
        assert [r.name for r in inner] == want
        for a, b in zip(inner, inner[1:]):
            assert a.end <= b.start
        assert s.start <= inner[0].start and inner[-1].end <= s.end
    packs = [r for r in recs if r.name == "prefetch.pack"]
    assert packs and {r.thread for r in packs} != {main}
    assert len({r.thread for r in packs}) == 1
    ordinals = [r.ordinal for r in packs]
    assert ordinals == sorted(set(ordinals))
    assert set(range(STEPS)) <= set(ordinals)
    assert all(r.start <= r.end for r in packs)
    assert not [r for r in recs if r.name == "prefetch.copy"]
    names = {e.name for e in prof.events()}
    assert {"trainer.step", *INNER} <= names
    assert "prefetch.pack" not in names


def test_profiler_leaves_the_parameters_unchanged(ds):
    out = []
    for profiled in (False, True):
        tr = _trainer()
        trace.follow_profiler()
        if profiled:
            with torch.profiler.profile(activities=CPU):
                _train(ds, tr)
            assert trace.spans()
        else:
            _train(ds, tr)
        out.append([p.detach().clone() for p in leaves(tr.params)])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_buffer_is_bounded_and_a_new_session_clears_it():
    trace.follow_profiler()
    with torch.profiler.profile(activities=CPU):
        assert trace.follow_profiler(7)
        for k in range(trace.CAPACITY + 10):
            trace.record("prefetch.pack", k, k + 0.5, k)
        with trace.span("trainer.step"):
            pass
    recs = trace.spans()
    assert len(recs) == trace.CAPACITY
    assert recs[0].ordinal == 11 and recs[-1].name == "trainer.step"
    assert recs[-1].ordinal == 7
    # off: the session's records stay readable
    assert trace.follow_profiler() is False
    assert len(trace.spans()) == trace.CAPACITY
    with torch.profiler.profile(activities=CPU):
        assert trace.follow_profiler() is True
        assert trace.spans() == []
        assert trace.follow_profiler() is True
        with trace.span("trainer.step"):
            pass
        assert [r.name for r in trace.spans()] == ["trainer.step"]
    trace.follow_profiler()
