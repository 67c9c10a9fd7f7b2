"""The port's runtime (DESIGN.md §8) on the CPU: its MessagePack codec byte
for byte against the ``msgpack`` package, checkpoints crossing both ways
between the packages bit for bit (f32, int and bf16 leaves, the Trainer
state), the checkpoint, async-writer, sentinel, chaos, restart,
straggler and fault-injector tests of tests/test_fault_recovery.py and
test_optim_runtime.py, the Trainer's checkpoint round trip and restart
of test_trainer_e2e.py, the four checkpoint tests of test_precision.py,
the packed-GatedMLP migration of test_fused_message_passing.py, and the
end-to-end chaos scenarios: a real SIGTERM resumed bit for bit, a NaN
streak rolled back once, a crash with bounded rework.  The port trains
FAST_FUSED (narrowed, its kernels' plain versions on the CPU)."""
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax  # noqa: E402

from repro.configs import chgnet_mptrj as JC  # noqa: E402
from repro.core import interaction as jinter  # noqa: E402
from repro.runtime import checkpoint as jckpt  # noqa: E402
from repro.train import trainer as jtrain  # noqa: E402
from repro_torch.batching import StepPlan, capacity_for, ladder_for  # noqa: E402
from repro_torch.configs import chgnet_mptrj as TC  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.graph import FIELDS, CrystalGraphBatch  # noqa: E402
from repro_torch.core.interaction import (  # noqa: E402
    gated_mlp_init,
    gated_mlp_legacy_template,
    pack_gated_mlp_params,
)
from repro_torch.data import (  # noqa: E402
    BalancedBatchIterator,
    BatchIterator,
    SyntheticConfig,
    TaggedBatch,
    make_dataset,
)
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    AsyncCheckpointWriter,
    ChaosMonkey,
    ChaosSchedule,
    CheckpointCorruptError,
    DeviceDropInjector,
    DeviceLossError,
    DivergenceSentinel,
    FaultInjector,
    GracefulShutdown,
    MissingLeafError,
    PreemptionError,
    StragglerWatch,
    TransientSampleError,
    corrupt_newest_checkpoint,
    host_snapshot,
    latest_step,
    latest_valid_step,
    list_checkpoints,
    poison_nan,
    read_resume_marker,
    restore_checkpoint,
    run_with_restarts,
    save_checkpoint,
    verify_checkpoint,
)
from repro_torch.runtime import _msgpack  # noqa: E402
from repro_torch.runtime.checkpoint import _ckpt_path, leaf_keys  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402

SMALL = dict(dim=16, num_blocks=1, num_rbf=7, num_fourier=7)
CFG = TC.FAST_FUSED.with_(**SMALL)
BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tests take many small
    training steps, which a pool of threads in each of several test
    workers only oversubscribes (spinning threads slow every worker)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    ds = make_dataset(SyntheticConfig(num_crystals=16, max_atoms=10, seed=0))
    return ds, capacity_for(ds, BATCH)


def _step_batches(ds, caps, start, stop, *, tag=False):
    """The batch of step s is a function of s alone: a run resumed at step
    k sees the data an uninterrupted run saw."""
    for s in range(start, stop):
        yield next(iter(BatchIterator(ds, BATCH, 1, caps, seed=s,
                                      tag_indices=tag)))


def _tcfg(steps, **kw):
    return TrainConfig(global_batch=BATCH, total_steps=steps, **kw)


def _tree(val, n=4096):
    return {"w": torch.full((n,), float(val)),
            "b": torch.arange(8, dtype=torch.float32) * val}


# ---------------------------------------------------------------------------
# the MessagePack codec, byte for byte against the msgpack package
# ---------------------------------------------------------------------------

_OBJECTS = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.5, -0.0, 1e300, float("inf"), "", "a" * 31,
    "a" * 32, "a" * 255, "a" * 256, "a" * 70000, "héllo ['w']", b"",
    b"x" * 255, b"x" * 256, b"x" * 70000, [], list(range(15)),
    list(range(16)), list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {f"k{i}": i for i in range(70000)},
    {"a": {"b": [1, 2.5, None, b"z", True]}}, (1, "2"),
]


@pytest.mark.parametrize("obj", _OBJECTS, ids=range(len(_OBJECTS)))
def test_msgpack_codec_is_bytewise_equal(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == want
    got = _msgpack.unpackb(want)
    assert got == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("raw", [
    b"\x92\x01", b"\x01\x02", b"\xc1", b"\x81\x01\x02", b"\xc4\x05ab",
    b"\xd9\x03a", b"\xcb\x00\x00", b"\xdd\xff\xff\xff\xff", b"",
])
def test_msgpack_codec_rejects_bad_input(raw):
    with pytest.raises(ValueError):
        _msgpack.unpackb(raw)
    with pytest.raises(TypeError):
        _msgpack.packb({"a": object()})


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _mixed_tree(seed=0):
    """numpy leaves of every dtype the Trainer state holds."""
    rng = np.random.default_rng(seed)
    return {"params": {"blocks": [{"w": rng.normal(size=(3, 5))
                                   .astype(np.float32)},
                                  {"w": rng.normal(size=(7,))
                                   .astype(np.float32)}],
                       "emb": rng.normal(size=(4, 2)).astype(np.float32),
                       "half": rng.normal(size=(3, 3)).astype(
                           ml_dtypes.bfloat16)},
            "opt_state": {"count": np.asarray(7, np.int32),
                          "loss_scale": {"scale": np.asarray(4096.0,
                                                             np.float32),
                                         "good_steps": np.asarray(
                                             3, np.int32)},
                          "empty": np.zeros((0, 4), np.float32)}}


def _same_values(t_tree, j_tree):
    assert len(leaves(t_tree)) == len(jax.tree.leaves(j_tree))
    for key, t, j in zip(leaf_keys(t_tree), leaves(t_tree),
                         jax.tree.leaves(j_tree)):
        t, j = t.detach(), np.asarray(j)
        if t.dtype == torch.bfloat16:
            assert j.dtype.name == "bfloat16", key
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), j.view(np.int16), err_msg=key)
        else:
            assert t.numpy().dtype == j.dtype, key
            np.testing.assert_array_equal(t.numpy(), j, err_msg=key)


def test_leaf_keys_are_jax_keystr():
    tree = _mixed_tree()
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert leaf_keys(params_from_numpy(tree)) == want
    assert want[0] == "['opt_state']['count']"


def test_checkpoints_cross_both_ways_bit_for_bit(tmp_path):
    """A file JAX wrote restores into the port bit for bit, and the
    reverse; the two files of one tree have equal arrays and manifests,
    and here, with equal meta, equal bytes."""
    tree = _mixed_tree()
    ttree = params_from_numpy(tree)
    meta = {"model_cfg": {"dim": 16, "r_cut": 6.0, "readout": "direct",
                          "flag": True, "none": None}}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save_checkpoint(jdir, 3, tree, extra_meta=meta)
    save_checkpoint(tdir, 3, ttree, extra_meta=meta)
    jraw = open(_ckpt_path(jdir, 3), "rb").read()
    traw = open(_ckpt_path(tdir, 3), "rb").read()
    jpay, tpay = msgpack.unpackb(jraw, raw=False), msgpack.unpackb(
        traw, raw=False)
    assert list(tpay["arrays"]) == list(jpay["arrays"])
    assert tpay["arrays"] == jpay["arrays"]
    assert tpay["manifest"] == jpay["manifest"]
    assert traw == jraw
    # JAX's file into the port, onto a template of other values
    template = params_from_numpy(_mixed_tree(seed=1))
    got, step, got_meta = restore_checkpoint(jdir, template)
    assert step == 3 and got_meta == meta
    _same_values(got, tree)
    # the port's file into JAX
    jgot, step, _ = jckpt.restore_checkpoint(tdir, _mixed_tree(seed=2))
    assert step == 3
    _same_values(ttree, jgot)


def test_trainer_state_crosses_both_ways(tmp_path):
    """A JAX Trainer's checkpoint restores into the port's Trainer bit for
    bit (parameters recording gradients, Adam's count a CPU scalar), and
    the port's Trainer's into JAX's."""
    jtcfg = jtrain.TrainConfig(global_batch=BATCH, total_steps=10)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jtr = jtrain.Trainer(JC.FAST_FS_HEAD.with_(**SMALL), jtcfg, seed=3,
                         ckpt_dir=jdir)
    jtr.step = 5
    jtr.save()
    tr = Trainer(CFG, _tcfg(10), seed=9, device="cpu", ckpt_dir=jdir)
    assert tr.maybe_restore() and tr.step == 5
    _same_values(tr.state(), jax.device_get(jtr.state()))
    assert all(p.requires_grad and p.is_leaf for p in leaves(tr.params))
    assert tr.opt_state["count"].dtype == torch.int32
    tr.ckpt_dir = tdir
    tr.step = 6
    tr.save()
    jtr2 = jtrain.Trainer(JC.FAST_FS_HEAD.with_(**SMALL), jtcfg, seed=1,
                          ckpt_dir=tdir)
    assert jtr2.maybe_restore() and jtr2.step == 6
    _same_values(tr.state(), jax.device_get(jtr2.state()))


# ---------------------------------------------------------------------------
# verified checkpoints (tests/test_fault_recovery.py, test_optim_runtime.py)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_keep(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor(3, dtype=torch.int32)}}
    for step in (10, 20, 30, 40):
        save_checkpoint(d, step, tree, keep=2)
    assert latest_step(d) == 40
    got, step, _meta = restore_checkpoint(d, tree)
    assert step == 40
    assert torch.equal(got["a"], tree["a"])
    assert got["b"]["c"].dtype == torch.int32 and int(got["b"]["c"]) == 3
    assert list_checkpoints(d) == [30, 40]
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"a": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(d, {"a": torch.zeros((3, 3))})
    with pytest.raises(MissingLeafError) as info:
        restore_checkpoint(d, {"a": torch.zeros((2, 2)),
                               "z": torch.zeros(1)})
    assert info.value.leaf_path == "['z']"


def test_corrupt_newest_falls_back(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3):
        save_checkpoint(d, step, _tree(step), keep=5)
    corrupt_newest_checkpoint(d, mode="truncate")
    assert latest_step(d) == 3
    assert latest_valid_step(d) == 2
    assert not verify_checkpoint(_ckpt_path(d, 3))
    with pytest.warns(UserWarning, match="skipping invalid checkpoint"):
        state, step, _ = restore_checkpoint(d, _tree(0.0))
    assert step == 2
    assert torch.equal(state["w"], _tree(2)["w"])


def test_bitflip_detected_by_manifest(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1.0), keep=5)
    corrupt_newest_checkpoint(d, mode="bitflip", seed=0)
    assert not verify_checkpoint(_ckpt_path(d, 1))
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(d, _tree(0.0), fallback=False)


def test_explicit_step_restore_never_falls_back(tmp_path):
    d = str(tmp_path)
    for step in (1, 2):
        save_checkpoint(d, step, _tree(step), keep=5)
    corrupt_newest_checkpoint(d, mode="truncate")
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(d, _tree(0.0), step=2)


def test_prune_counts_only_valid_checkpoints(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3):
        save_checkpoint(d, step, _tree(step), keep=10)
    corrupt_newest_checkpoint(d, mode="truncate")
    save_checkpoint(d, 4, _tree(4), keep=2)
    steps = list_checkpoints(d)
    assert 2 in steps and 4 in steps
    assert latest_valid_step(d) == 4
    assert 1 not in steps


def test_all_corrupt_raises(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1.0), keep=5)
    corrupt_newest_checkpoint(d, mode="truncate")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(CheckpointCorruptError):
            restore_checkpoint(d, _tree(0.0))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), _tree(0.0))


def test_host_snapshot_is_an_aligned_copy():
    tree = {"a": torch.arange(5, dtype=torch.bfloat16),
            "b": [torch.arange(3, dtype=torch.float64),
                  torch.tensor(True), torch.zeros(0, 4)],
            "c": torch.tensor(2.5, requires_grad=True)}
    snap = host_snapshot(tree)
    for k, t, s in zip(leaf_keys(tree), leaves(tree), leaves(snap)):
        assert s.dtype == t.dtype and s.shape == t.shape, k
        assert torch.equal(s, t.detach()), k
        assert not s.requires_grad
    tree["b"][0] += 1.0
    assert torch.equal(snap["b"][0], torch.arange(3, dtype=torch.float64))
    with pytest.raises(TypeError):
        host_snapshot({"a": np.zeros(3)})


# ---------------------------------------------------------------------------
# the four checkpoint tests of tests/test_precision.py
# ---------------------------------------------------------------------------

def test_checkpoint_bf16_roundtrip(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) * 0.5,
            "b": torch.ones((4,), dtype=torch.float32),
            "n": torch.tensor(3, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 7, tree)
    got, step, _ = restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    for k in tree:
        assert got[k].dtype == tree[k].dtype, k
        assert torch.equal(got[k], tree[k]), k


def test_checkpoint_dtype_mismatch_warns_and_casts(tmp_path):
    stored = {"w": torch.linspace(0, 1, 8, dtype=torch.float32)}
    save_checkpoint(str(tmp_path), 1, stored)
    template = {"w": torch.zeros((8,), dtype=torch.bfloat16)}
    with pytest.warns(UserWarning, match="dtype mismatch"):
        got, _, _ = restore_checkpoint(str(tmp_path), template)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], stored["w"].to(torch.bfloat16))
    # numpy's (ml_dtypes) cast in the JAX package rounds the same way
    np.testing.assert_array_equal(
        got["w"].view(torch.int16).numpy(),
        stored["w"].numpy().astype(ml_dtypes.bfloat16).view(np.int16))


def test_legacy_f32_checkpoint_restores_into_mixed_trainer(tmp_path):
    """A checkpoint of an f32 Trainer (no loss_scale / master leaves)
    restores into a mixed-precision Trainer through the strip-and-regrow
    migration."""
    tcfg = _tcfg(10)
    tr32 = Trainer(CFG, tcfg, ckpt_dir=str(tmp_path), seed=3, device="cpu")
    assert "loss_scale" not in tr32.opt_state
    tr32.step = 4
    tr32.save()
    trmx = Trainer(TC.FAST_FUSED_MIXED.with_(**SMALL), tcfg,
                   ckpt_dir=str(tmp_path), seed=9, device="cpu")
    assert trmx.maybe_restore()
    assert trmx.step == 4
    for a, b in zip(leaves(trmx.params), leaves(tr32.params)):
        assert torch.equal(a, b)
    assert "loss_scale" in trmx.opt_state
    assert float(trmx.opt_state["loss_scale"]["scale"]) == \
        tcfg.loss_scale.init_scale


def test_bf16_trainer_checkpoint_roundtrip(tmp_path):
    """The whole bf16 Trainer state (bf16 params, f32 master, scaler)
    round-trips."""
    cfg = CFG.with_(precision="bf16")
    tcfg = _tcfg(10)
    tr = Trainer(cfg, tcfg, ckpt_dir=str(tmp_path), seed=1, device="cpu")
    tr.step = 2
    tr.save()
    tr2 = Trainer(cfg, tcfg, ckpt_dir=str(tmp_path), seed=5, device="cpu")
    assert tr2.maybe_restore() and tr2.step == 2
    for a, b in zip(leaves(tr2.state()), leaves(tr.state())):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert {p.dtype for p in leaves(tr2.params)} >= {torch.bfloat16}
    assert {m.dtype for m in leaves(tr2.opt_state["master"])} == \
        {torch.float32}


# ---------------------------------------------------------------------------
# the packed GatedMLP (tests/test_fused_message_passing.py)
# ---------------------------------------------------------------------------

def test_pack_legacy_roundtrip():
    packed = gated_mlp_init(torch.Generator().manual_seed(0), 96, 32)
    legacy = gated_mlp_legacy_template(packed)
    assert set(legacy) == {"wc", "bc", "wg", "bg", "ln_c_scale",
                           "ln_c_bias", "ln_g_scale", "ln_g_bias"}
    repacked = pack_gated_mlp_params(legacy)
    for k in packed:
        assert torch.equal(packed[k], repacked[k]), k
    # the JAX package's templates agree key for key and value for value
    jlegacy = jinter.gated_mlp_legacy_template(
        {k: np.asarray(v) for k, v in packed.items()})
    for k in jlegacy:
        np.testing.assert_array_equal(legacy[k].numpy(),
                                      np.asarray(jlegacy[k]), err_msg=k)


def test_trainer_restores_legacy_checkpoint(tmp_path):
    """A checkpoint of the old separate-weight layout, here written by the
    JAX package, restores into the packed layout (packed once at load)."""
    trainer = Trainer(CFG, _tcfg(10), seed=0, ckpt_dir=str(tmp_path),
                      device="cpu")
    state = jax.tree.map(lambda x: x.detach().numpy() + 1.0
                         if x.is_floating_point() else x.numpy(),
                         trainer.state())
    legacy_state = jinter.gated_mlp_legacy_template(state)
    jckpt.save_checkpoint(str(tmp_path), 5, legacy_state)
    assert trainer.maybe_restore()
    assert trainer.step == 5
    want = jinter.pack_gated_mlp_params(legacy_state)
    _same_values(trainer.state(), want)
    assert all(p.requires_grad and p.is_leaf for p in leaves(trainer.params))


# ---------------------------------------------------------------------------
# async writer
# ---------------------------------------------------------------------------

def test_async_writer_matches_sync_bytes(tmp_path):
    sync_d, async_d = str(tmp_path / "s"), str(tmp_path / "a")
    for step in (1, 2, 3):
        save_checkpoint(sync_d, step, _tree(step), keep=2)
    with AsyncCheckpointWriter(async_d, keep=2) as w:
        for step in (1, 2, 3):
            w.save(step, _tree(step))
        w.flush()
        assert w.last_written_step == 3
        assert w.writes == 3
    assert not w._thread.is_alive()
    assert list_checkpoints(sync_d) == list_checkpoints(async_d) == [2, 3]
    for step in (2, 3):
        a = open(_ckpt_path(sync_d, step), "rb").read()
        b = open(_ckpt_path(async_d, step), "rb").read()
        assert a == b


def test_async_writer_snapshot_isolation(tmp_path):
    tree = {"w": torch.zeros(16)}
    with AsyncCheckpointWriter(str(tmp_path)) as w:
        w.save(1, tree)
        tree["w"] += 999.0
        w.flush()
    state, _, _ = restore_checkpoint(str(tmp_path), {"w": torch.zeros(16)})
    assert torch.equal(state["w"], torch.zeros(16))


def test_async_writer_surfaces_worker_error(tmp_path):
    blocked = tmp_path / "not_a_dir"
    blocked.write_text("occupied")
    w = AsyncCheckpointWriter(str(blocked))
    w.save(1, _tree(1.0))
    with pytest.raises(RuntimeError, match="NOT durable"):
        w.flush()
    w.close()
    assert not w._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        w.save(2, _tree(2.0))


# ---------------------------------------------------------------------------
# divergence sentinel, straggler watch, fault injectors
# ---------------------------------------------------------------------------

def test_sentinel_nan_streak_trips():
    s = DivergenceSentinel(nan_streak=2)
    assert not s.record(float("nan"))
    assert s.suspicious
    assert s.record(float("nan"))
    assert s.last_trip_len == 2
    assert not s.suspicious


def test_sentinel_scaler_skipped_exempt():
    s = DivergenceSentinel(nan_streak=1)
    for _ in range(10):
        assert not s.record(float("nan"), scaler_skipped=True)
    assert not s.suspicious


def test_sentinel_spike_streak_trips_and_median_uncontaminated():
    s = DivergenceSentinel(spike_factor=10.0, spike_streak=3, min_history=4)
    for _ in range(8):
        assert not s.record(1.0)
    assert not s.record(50.0)
    assert not s.record(50.0)
    assert s.record(50.0)
    for _ in range(2):
        assert not s.record(50.0)
    assert s.record(50.0)


def test_sentinel_isolated_spike_no_trip():
    s = DivergenceSentinel(spike_streak=2, min_history=4)
    for _ in range(6):
        s.record(1.0)
    assert not s.record(100.0)
    assert not s.record(1.0)
    assert not s.record(100.0)


def test_straggler_watch_flags_slow_steps():
    w = StragglerWatch(window=16, threshold=2.0)
    for _ in range(10):
        w.record(0.1)
    assert w.record(0.5) is True
    assert w.flags == 1


def test_fault_injector_fires_once():
    fi = FaultInjector({3})
    fi.maybe_fail(2)
    with pytest.raises(RuntimeError):
        fi.maybe_fail(3)
    fi.maybe_fail(3)
    drop = DeviceDropInjector(fail_at_step=2, device_index=1)
    drop.maybe_fail(1)
    with pytest.raises(DeviceLossError) as info:
        drop.maybe_fail(2)
    assert info.value.failed_index == 1
    drop.maybe_fail(2)


# ---------------------------------------------------------------------------
# chaos schedule, restarts
# ---------------------------------------------------------------------------

def test_chaos_schedule_parse_roundtrip():
    spec = "nan@5,sigterm@12,drop@7:0,straggler@9:0.2"
    sched = ChaosSchedule.parse(spec, seed=3)
    assert sched.spec() == "nan@5,drop@7:0,straggler@9:0.2,sigterm@12"
    assert ChaosSchedule.parse(sched.spec(), seed=3) == sched
    assert [e.kind for e in sched.at(7, frozenset({"drop"}))] == ["drop"]
    monkey = ChaosMonkey(ChaosSchedule.parse("drop@1:2,crash@2"))
    with pytest.raises(DeviceLossError):
        monkey.maybe_fail(1)
    with pytest.raises(RuntimeError, match="crash"):
        monkey.maybe_fail(2)
    monkey.maybe_fail(2)  # fired once
    assert monkey.log_events == [("drop", 1), ("crash", 2)]


def test_chaos_schedule_rejects_bad_tokens():
    with pytest.raises(ValueError):
        ChaosSchedule.parse("frobnicate@3")
    with pytest.raises(ValueError):
        ChaosSchedule.parse("nan@notastep")


def test_chaos_stream_poisons_tagged_batches_and_plans(setup):
    ds, caps = setup
    plan = BalancedBatchIterator(ds, 8, 1, ladder_for(ds, 4),
                                 num_micro=2).plan_step(np.arange(8))
    tagged = next(_step_batches(ds, caps, 0, 1, tag=True))
    items = [tagged, plan, tagged]
    stream = ChaosMonkey(ChaosSchedule.parse("nan@0,nan@1,transient@2"))\
        .wrap_batches(iter(items))
    got = [next(stream), next(stream)]
    with pytest.raises(TransientSampleError):
        next(stream)
    assert isinstance(got[0], TaggedBatch)
    np.testing.assert_array_equal(got[0].indices, tagged.indices)
    assert isinstance(got[1], StepPlan) and len(got[1].micro) == 2
    for b in [got[0].batch] + got[1].micro:
        assert isinstance(b, CrystalGraphBatch)
        for k in FIELDS:
            t = getattr(b, k)
            if t.is_floating_point():
                assert bool(torch.isnan(t).all()), k
            else:
                assert not torch.is_floating_point(t), k
    assert torch.equal(got[0].batch.atom_z, tagged.batch.atom_z)
    assert bool(torch.isnan(poison_nan(torch.zeros(3))).all())
    with pytest.raises(TypeError):
        poison_nan("batch")


def test_run_with_restarts_fails_fast_on_programming_errors():
    calls = []

    def loop(start):
        calls.append(start)
        raise ValueError("config typo")

    with pytest.raises(ValueError):
        run_with_restarts(loop, resume_step_fn=lambda: 0, max_restarts=5)
    assert len(calls) == 1


def test_run_with_restarts_never_retries_preemption():
    calls = []

    def loop(start):
        calls.append(start)
        raise PreemptionError(7)

    with pytest.raises(PreemptionError):
        run_with_restarts(loop, resume_step_fn=lambda: 0, max_restarts=5)
    assert len(calls) == 1


def test_run_with_restarts_recovers_and_gives_up():
    calls = {"n": 0}

    def loop(start):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("boom")
        return f"done from {start}"

    out = run_with_restarts(loop, resume_step_fn=lambda: calls["n"] * 100,
                            max_restarts=5)
    assert out == "done from 200" and calls["n"] == 3

    def always(start):
        raise RuntimeError("always")

    with pytest.raises(RuntimeError):
        run_with_restarts(always, resume_step_fn=lambda: 0, max_restarts=2)


# ---------------------------------------------------------------------------
# the Trainer end to end (tests/test_trainer_e2e.py, test_fault_recovery.py)
# ---------------------------------------------------------------------------

def test_checkpoint_restore_trainer_roundtrip(tmp_path, setup):
    ds, caps = setup
    ckpt = str(tmp_path / "c2")
    tr = Trainer(CFG, _tcfg(10), ckpt_dir=ckpt, ckpt_every=1, device="cpu")
    tr.train(_step_batches(ds, caps, 0, 2))
    tr.save()
    tr2 = Trainer(CFG, _tcfg(10), ckpt_dir=ckpt, device="cpu")
    assert tr2.maybe_restore()
    assert tr2.step == tr.step == 2
    for a, b in zip(leaves(tr.state()), leaves(tr2.state())):
        assert torch.equal(a, b)


def test_fault_injection_restart_resumes(tmp_path, setup):
    """An injected fault at step 5; the restart resumes from the
    checkpoint and completes."""
    ds, caps = setup
    ckpt = str(tmp_path / "ckpt")
    starts = []

    def run_loop(start_step):
        tr = Trainer(CFG, _tcfg(100), ckpt_dir=ckpt, ckpt_every=2,
                     device="cpu")
        tr.maybe_restore()
        assert tr.step == start_step
        starts.append(start_step)
        fi = FaultInjector({5}) if start_step == 0 else None
        tr.train(_step_batches(ds, caps, tr.step, 10), fault_injector=fi)
        tr.save()
        return tr.step

    final = run_with_restarts(run_loop, resume_step_fn=lambda:
                              latest_step(ckpt) or 0, max_restarts=2)
    assert final == 10
    assert starts == [0, 4]


def test_sigterm_resume_bit_identical(setup, tmp_path):
    """A real SIGTERM at step 3 (the chaos monkey): a durable checkpoint and
    the resume marker at step 4, and the resumed run's parameters equal an
    uninterrupted run's bit for bit (async checkpoints on)."""
    ds, caps = setup
    steps, d = 6, str(tmp_path)
    ref = Trainer(CFG, _tcfg(steps), device="cpu")
    ref.train(_step_batches(ds, caps, 0, steps))
    monkey = ChaosMonkey(ChaosSchedule.parse("sigterm@3"))
    with GracefulShutdown() as shutdown:
        tr = Trainer(CFG, _tcfg(steps), ckpt_dir=d, ckpt_every=2,
                     async_ckpt=True, shutdown=shutdown, device="cpu")
        with pytest.raises(PreemptionError) as info:
            tr.train(_step_batches(ds, caps, 0, steps),
                     fault_injector=monkey)
        tr.close()
        assert len(info.value.partial_history) == 4
        marker = read_resume_marker(d)
        assert marker is not None and marker["step"] == tr.step == 4
        assert marker["reason"] == "signal 15"
        assert latest_valid_step(d) == 4
        shutdown.requested = False
        res = Trainer(CFG, _tcfg(steps), ckpt_dir=d, shutdown=shutdown,
                      device="cpu")
        assert res.maybe_restore() and res.step == 4
        res.train(_step_batches(ds, caps, res.step, steps))
    assert res.step == steps
    for a, b in zip(leaves(ref.state()), leaves(res.state())):
        assert torch.equal(a, b)


def _chaos_run(ds, caps, d, *, steps=8, ckpt_every=2, chaos="nan@3,nan@4",
               max_attempts=6):
    """A launcher-style restart loop under a chaos schedule: (trainer, the
    whole metric history, rollbacks and quarantine across attempts)."""
    monkey = ChaosMonkey(ChaosSchedule.parse(chaos), ckpt_dir=d)
    history, attempts = [], 0
    stats = {"rollbacks": 0, "quarantined": set()}
    while True:
        attempts += 1
        assert attempts <= max_attempts
        tr = Trainer(CFG, _tcfg(steps, rollback_on_divergence=True,
                                divergence_nan_streak=2),
                     ckpt_dir=d, ckpt_every=ckpt_every, device="cpu")
        tr.maybe_restore()
        stream = monkey.wrap_batches(
            _step_batches(ds, caps, tr.step, steps, tag=True),
            start_step=tr.step)
        try:
            history.extend(tr.train(stream, fault_injector=monkey))
        except PreemptionError:
            raise
        except Exception as exc:  # the injected crash: restart
            history.extend(getattr(exc, "partial_history", []))
            tr.close()
            continue
        finally:
            stats["rollbacks"] += tr.rollbacks
            stats["quarantined"] |= tr.quarantined
        if tr.step >= steps:
            return tr, history, stats


def test_nan_rollback_quarantines_and_descends(setup, tmp_path):
    ds, caps = setup
    tr, history, stats = _chaos_run(ds, caps, str(tmp_path))
    assert tr.step == 8
    assert stats["rollbacks"] == 1
    assert stats["quarantined"]
    # the halved LR survived the checkpoint into the second attempt
    assert float(tr.opt_state["lr_scale"]) == 0.5
    # step 3's NaN loss is on record, every step after the rollback finite
    assert [i for i, h in enumerate(history)
            if not np.isfinite(h["loss"])] == [3]
    d = str(tmp_path)
    assert all(verify_checkpoint(_ckpt_path(d, s))
               for s in list_checkpoints(d))


def test_rollback_halves_lr_and_quarantines_indices(setup, tmp_path):
    """Within one Trainer: the NaN streak restores step 2, backs the LR off
    to 0.5 (in opt_state, so it is checkpointed) and hands the streak's
    dataset indices to on_quarantine."""
    ds, caps = setup
    d = str(tmp_path)
    tr = Trainer(CFG, _tcfg(8, rollback_on_divergence=True), ckpt_dir=d,
                 ckpt_every=2, device="cpu")
    seen = []
    tr.on_quarantine = seen.extend
    stream = ChaosMonkey(ChaosSchedule.parse("nan@3,nan@4")).wrap_batches(
        _step_batches(ds, caps, 0, 8, tag=True))
    hist = tr.train(stream)
    assert tr.rollbacks == 1 and tr.step == 5
    # steps 0-3 (3 poisoned, its NaN recorded), the trip at batch 4 (not
    # a step), then steps 2-4 again from the checkpoint of step 2
    assert len(hist) == 7
    assert [np.isfinite(h["loss"]) for h in hist] == [True] * 3 + [False] \
        + [True] * 3
    assert float(tr.opt_state["lr_scale"]) == 0.5
    assert hist[-1]["lr_scale"] == 0.5
    want = set()
    for s in (3, 4):
        want |= set(next(_step_batches(ds, caps, s, s + 1, tag=True))
                    .indices.tolist())
    assert set(seen) == tr.quarantined == want


def test_same_seed_and_schedule_identical_history(setup, tmp_path):
    ds, caps = setup
    _, h1, _ = _chaos_run(ds, caps, str(tmp_path / "run1"))
    _, h2, _ = _chaos_run(ds, caps, str(tmp_path / "run2"))
    assert len(h1) == len(h2)
    np.testing.assert_equal(h1, h2)


def test_crash_recovery_bounded_rework(setup, tmp_path):
    ds, caps = setup
    tr, history, _ = _chaos_run(ds, caps, str(tmp_path), chaos="crash@5",
                                ckpt_every=2)
    assert tr.step == 8
    assert len(history) - tr.step <= 2


def test_nonfinite_loss_without_sentinel_restores_or_raises(setup, tmp_path):
    ds, caps = setup
    tr = Trainer(CFG, _tcfg(8), device="cpu")
    poisoned = poison_nan(next(_step_batches(ds, caps, 0, 1)))
    with pytest.raises(FloatingPointError, match="non-finite"):
        tr.train([poisoned])
    d = str(tmp_path)
    tr = Trainer(CFG, _tcfg(8), ckpt_dir=d, ckpt_every=1, device="cpu")
    tr.train(_step_batches(ds, caps, 0, 1))
    tr.train([poisoned])  # restores step 1 and goes on
    assert tr.step == 1
    assert all(bool(torch.isfinite(p).all()) for p in leaves(tr.params))


def test_trainer_mesh_still_raises_item_13(setup, tmp_path):
    """``mesh=``, which waited for ROADMAP item 13, is ported: on a
    one-rank gloo mesh the Trainer writes its checkpoints as rank 0 (then
    a barrier) and a second one restores the same file bit for bit; a
    device other than the mesh's still raises."""
    import torch.distributed as dist

    from repro_torch.distributed import init_data_mesh

    ds, caps = setup
    d = str(tmp_path / "ckpt")
    mesh = init_data_mesh("cpu", rank=0, world_size=1,
                          init_method=f"file://{tmp_path}/store")
    try:
        tr = Trainer(CFG, _tcfg(8), mesh=mesh, ckpt_dir=d, ckpt_every=2)
        tr.train(_step_batches(ds, caps, 0, 2))
        assert latest_valid_step(d) == 2
        back = Trainer(CFG, _tcfg(8), seed=1, mesh=mesh, ckpt_dir=d)
        assert back.maybe_restore() and back.step == 2
        assert all(torch.equal(a, b) for a, b in zip(leaves(tr.state()),
                                                     leaves(back.state())))
        with pytest.raises(ValueError, match="mesh's device"):
            Trainer(CFG, TrainConfig(), device="meta", mesh=mesh)
    finally:
        dist.destroy_process_group()


def test_launcher_trains_resumes_and_refuses(tmp_path):
    """The launcher on the CPU: --balance cost --accum 2 with async
    checkpoints to step 2, then again to step 3, resuming from step 2; an
    LM architecture (rwkv6-3b) trains its SMOKE config and returns its
    step count (``--devices``: tests/test_torch_dp.py; LM training:
    tests/test_torch_lm_train.py)."""
    from repro_torch.launch import train as launch

    d = str(tmp_path / "ckpt")
    common = ["--device", "cpu", "--batch", "4", "--crystals", "8",
              "--balance", "cost", "--accum", "2", "--conv-impl", "fused",
              "--ckpt", d, "--async-ckpt", "--ckpt-every", "2",
              "--cost-refit-every", "2"]
    assert launch.main(["--steps", "2"] + common) == 2
    assert latest_valid_step(d) == 2
    assert launch.main(["--steps", "3"] + common) == 3
    assert latest_valid_step(d) == 3
    assert launch.main(["--arch", "rwkv6-3b", "--device", "cpu",
                        "--steps", "2"]) == 2
