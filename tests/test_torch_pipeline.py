"""The port's capacity ladder, quarantine hooks and Prefetcher
(``repro_torch.batching.ladder_for``, ``repro_torch.data``) against the
JAX package's (``repro.batching``, ``repro.data``) on the CPU: equal
buckets, bitwise-equal batches seed for seed, and the Prefetcher tests of
``tests/test_batching.py``, ``test_sampler_pipeline.py`` and
``test_fault_recovery.py`` mirrored.  Every wait on a prefetcher's thread
is bounded, so no test can hang the run.
"""
from __future__ import annotations

import itertools
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.batching import ladder_for as j_ladder  # noqa: E402
from repro.data import BatchIterator as JIter  # noqa: E402
from repro.data import Prefetcher as JPrefetcher  # noqa: E402
from repro.data import SyntheticConfig as JSyn  # noqa: E402
from repro.data import make_dataset as j_dataset  # noqa: E402
from repro.runtime.fault import TransientSampleError as JTSE  # noqa: E402
from repro_torch import batching, data  # noqa: E402
from repro_torch.batching import ladder_for  # noqa: E402
from repro_torch.core.graph import FIELDS, CrystalGraphBatch  # noqa: E402
from repro_torch.data import (  # noqa: E402
    BatchIterator,
    Prefetcher,
    SyntheticConfig,
    TransientSampleError,
    make_dataset,
)
from repro_torch.runtime import TransientSampleError as RuntimeTSE  # noqa: E402
from repro_torch.train import trainer as ttrain  # noqa: E402
from repro_torch.configs import chgnet_mptrj  # noqa: E402

SYN = dict(num_crystals=64, max_atoms=32, seed=0)
JOIN_S = 5.0  # the longest any test waits for a prefetcher's thread


@pytest.fixture(scope="module")
def datasets():
    return j_dataset(JSyn(**SYN)), make_dataset(SyntheticConfig(**SYN))


def _caps(b):
    return (b.atoms, b.bonds, b.angles, b.und_cap, b.und_angle_cap)


def _assert_batches_equal(jb, tb):
    for k in FIELDS:
        want, got = np.asarray(getattr(jb, k)), getattr(tb, k).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


# ---------------------------------------------------------------------------
# ladder_for
# ---------------------------------------------------------------------------

def test_ladder_ascends_and_top_fits_dataset(datasets):
    _, ds = datasets
    lad = ladder_for(ds, per_device_batch=4, num_buckets=4)
    totals = [b.total for b in lad.buckets]
    assert totals == sorted(totals) and len(set(totals)) == len(totals)
    # the top bucket fits any 4 samples drawn from the dataset
    na = 4 * max(c.num_atoms for c in ds.crystals)
    nb = 4 * max(g.num_bonds for g in ds.graphs)
    ng = 4 * max(g.num_angles for g in ds.graphs)
    assert lad.top.fits(na, nb, ng)


@pytest.mark.parametrize("batch,buckets,margin", [
    (4, 4, 1.3), (4, 3, 1.3), (8, 2, 1.0), (16, 5, 1.5), (1, 1, 1.3)])
def test_ladder_matches_jax(datasets, batch, buckets, margin):
    jds, tds = datasets
    want = j_ladder(jds, batch, num_buckets=buckets, margin=margin)
    got = ladder_for(tds, batch, num_buckets=buckets, margin=margin)
    assert [_caps(b) for b in got.buckets] == \
        [_caps(b) for b in want.buckets]
    assert got.align == want.align


def test_ladder_of_the_default_dataset_at_batch_128():
    """The buckets the training phases of chip_smoke.py run on: the
    default synthetic dataset (256 crystals of 2-64 atoms) at batch 128,
    equal to the JAX package's."""
    tds = make_dataset(SyntheticConfig())
    got = ladder_for(tds, 128)
    assert [(b.atoms, b.bonds, b.angles) for b in got.buckets] == [
        (1536, 96064, 67776), (2496, 157248, 127552),
        (5504, 318656, 346496), (10752, 737152, 663296)]
    want = j_ladder(j_dataset(JSyn()), 128)
    assert [_caps(b) for b in got.buckets] == \
        [_caps(b) for b in want.buckets]


def test_ladder_for_is_exported_where_jax_exports_it():
    assert batching.ladder_for is data.ladder_for is ladder_for
    assert data.capacity_for is batching.capacity_for
    assert TransientSampleError is RuntimeTSE


# ---------------------------------------------------------------------------
# BatchIterator on a ladder, and its quarantine
# ---------------------------------------------------------------------------

def test_batch_iterator_with_ladder(datasets):
    _, ds = datasets
    lad = ladder_for(ds, per_device_batch=4, num_buckets=3)
    it = BatchIterator(ds, global_batch=8, num_devices=1, caps=lad)
    seen = set()
    for i, batch in enumerate(it):
        assert float(batch.crystal_mask.sum()) == 8
        assert (batch.atom_cap, batch.bond_cap, batch.angle_cap) in {
            (b.atoms, b.bonds, b.angles) for b in lad.buckets}
        seen.add(batch.atom_z.shape)
        if i >= 3:
            break
    assert len(seen) >= 1  # bucketed shapes, all packed without error


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("load_balance", [True, False])
def test_batch_iterator_on_ladder_is_bitwise_equal(datasets, seed,
                                                   load_balance):
    """Same seed, same ladder: the same bucket and every one of the 35
    fields, batch for batch."""
    jds, tds = datasets
    jit = JIter(jds, 8, 1, j_ladder(jds, 8), load_balance=load_balance,
                seed=seed, drop_last=False)
    tit = BatchIterator(tds, 8, 1, ladder_for(tds, 8),
                        load_balance=load_balance, seed=seed,
                        drop_last=False)
    n = 0
    for jb, tb in itertools.zip_longest(jit, tit):
        _assert_batches_equal(jb, tb)
        n += 1
    assert n == 8


def test_quarantine_drops_indices_as_jax_does(datasets):
    jds, tds = datasets
    jit = JIter(jds, 8, 1, j_ladder(jds, 8), seed=4)
    tit = BatchIterator(tds, 8, 1, ladder_for(tds, 8), seed=4)
    bad = [3, 10, 11, 40]
    jit.add_quarantine(bad)
    tit.add_quarantine(np.array(bad))
    assert tit.quarantine == set(bad)
    n = 0
    for jb, tb in itertools.zip_longest(jit, tit):
        _assert_batches_equal(jb, tb)
        n += 1
    assert n == 8
    # quarantined crystals leave fewer real crystal slots in an epoch
    assert sum(int(b.crystal_mask.sum()) for b in tit) == 64 - len(bad)


def test_quarantine_skips_a_step_whose_shard_would_go_empty(datasets):
    _, tds = datasets
    it = BatchIterator(tds, 4, 1, batching.capacity_for(tds, 4), seed=0)
    first = next(iter(BatchIterator(tds, 4, 1,
                                    batching.capacity_for(tds, 4), seed=0)))
    it.add_quarantine(range(64))
    assert list(it) == []
    assert first.num_crystals == 4


# ---------------------------------------------------------------------------
# Prefetcher
# ---------------------------------------------------------------------------

class _FlakySource:
    """A resumable source that raises TransientSampleError at given
    indices (or always)."""

    def __init__(self, n, fail_at=(), always_fail=False):
        self.n, self.fail_at, self.always_fail = n, set(fail_at), always_fail
        self.i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.i >= self.n:
            raise StopIteration
        i = self.i
        self.i += 1
        if self.always_fail or i in self.fail_at:
            raise TransientSampleError(index=i)
        return i


class _JFlakySource(_FlakySource):
    """The same source raising the JAX package's exception."""

    def __next__(self):
        try:
            return super().__next__()
        except TransientSampleError as exc:
            raise JTSE(index=exc.index) from None


def _drain(pf):
    """Everything the prefetcher yields, then its thread joined."""
    try:
        return list(pf)
    finally:
        pf.thread.join(JOIN_S)
        assert not pf.thread.is_alive()


def test_prefetcher_yields_everything():
    items = list(range(7))
    assert _drain(Prefetcher(iter(items), depth=2)) == items


def test_prefetcher_propagates_all_despite_slow_consumer():
    pf = Prefetcher(iter(range(5)), depth=1)
    out = []
    for x in pf:
        time.sleep(0.01)
        out.append(x)
    assert out == [0, 1, 2, 3, 4]
    pf.thread.join(JOIN_S)
    assert not pf.thread.is_alive()


def test_prefetcher_reraises_worker_exception():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("bad batch")

    pf = Prefetcher(gen(), depth=1)
    got = []
    with pytest.raises(RuntimeError, match="bad batch"):
        for x in pf:
            got.append(x)
    assert got == [1, 2]  # items before the failure still delivered
    pf.thread.join(JOIN_S)
    assert not pf.thread.is_alive()


def test_prefetcher_quarantines_transient_and_continues():
    pf = Prefetcher(_FlakySource(6, fail_at={2, 4}), backoff=0.001)
    assert _drain(pf) == [0, 1, 3, 5]
    assert pf.quarantined == [2, 4]


def test_prefetcher_escalates_after_max_retries():
    pf = Prefetcher(_FlakySource(6, always_fail=True), max_retries=2,
                    backoff=0.001)
    with pytest.raises(TransientSampleError):
        _drain(pf)
    # two failures in a row were retried, the third escalated; all three
    # were quarantined, as the JAX package's Prefetcher does
    assert pf.quarantined == [0, 1, 2]
    jpf = JPrefetcher(_JFlakySource(6, always_fail=True), max_retries=2,
                      backoff=0.001)
    with pytest.raises(JTSE):
        list(jpf)
    assert jpf.quarantined == pf.quarantined


def test_prefetcher_early_break_joins_worker():
    # infinite source + tiny queue: the worker is blocked on put
    pf = Prefetcher(itertools.count(), depth=1)
    for x in pf:
        if x >= 1:
            break  # the consumer leaves early; close() runs via finally
    pf.thread.join(JOIN_S)
    assert not pf.thread.is_alive()


def test_prefetcher_worker_crash_reraised_in_consumer():
    def boom():
        yield 1
        raise RuntimeError("worker died")

    pf = Prefetcher(boom())
    with pytest.raises(RuntimeError, match="worker died"):
        _drain(pf)


def test_prefetcher_counts_its_items_and_times():
    pf = Prefetcher(iter(range(4)), depth=2)
    assert _drain(pf) == [0, 1, 2, 3]
    assert pf.stats["items"] == 4
    assert min(pf.stats[k] for k in ("source_s", "copy_s", "wait_s")) >= 0


def test_prefetcher_on_cuda_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without CUDA")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        Prefetcher(iter([]), device="cuda")


def test_prefetcher_of_batches_yields_the_iterators_batches(datasets):
    """A BatchIterator through the Prefetcher (no device, and to the CPU
    device) gives its batches unchanged, field for field."""
    _, tds = datasets
    lad = ladder_for(tds, 8)
    want = list(BatchIterator(tds, 8, 1, lad, seed=3))
    for device in (None, "cpu"):
        got = _drain(Prefetcher(BatchIterator(tds, 8, 1, lad, seed=3),
                                device=device))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert isinstance(g, CrystalGraphBatch)
            for k in FIELDS:
                assert torch.equal(getattr(g, k), getattr(w, k)), k


def test_batch_to_keeps_every_field(datasets):
    _, tds = datasets
    b = next(iter(BatchIterator(tds, 4, 1, ladder_for(tds, 4))))
    moved = b.to("cpu", non_blocking=True)
    for k in FIELDS:
        assert torch.equal(getattr(moved, k), getattr(b, k)), k


def test_trainer_on_prefetched_ladder_batches_matches_direct(datasets):
    """Training on the ladder through the Prefetcher takes the same steps
    as on the BatchIterator directly: equal losses, bit for bit."""
    _, tds = datasets
    cfg = chgnet_mptrj.FAST_FS_HEAD.with_(dim=16, num_blocks=1, num_rbf=7,
                                          num_fourier=7)
    lad = ladder_for(tds, 8)
    losses = []
    for prefetch in (False, True):
        tr = ttrain.Trainer(cfg, ttrain.TrainConfig(global_batch=8),
                            seed=0, device="cpu")
        it = BatchIterator(tds, 8, 1, lad, seed=1)
        src = Prefetcher(it, depth=2) if prefetch else it
        hist = tr.train(itertools.islice(src, 3))
        if prefetch:
            src.close()
            assert not src.thread.is_alive()
        losses.append([h["loss"] for h in hist])
    assert losses[0] == losses[1] and len(losses[0]) == 3


def test_prefetcher_keeps_order_under_frequent_thread_switches():
    """The worker and the consumer hand items over through the queue and
    count into disjoint keys of ``stats``: with the interpreter switching
    threads every few microseconds, every item arrives once, in order,
    and the counts hold."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pf = Prefetcher(iter(range(3000)), depth=1)
        assert _drain(pf) == list(range(3000))
        assert pf.stats["items"] == 3000
    finally:
        sys.setswitchinterval(interval)
