"""The port's data parallelism (DESIGN.md §6) against the JAX package on
the CPU: each rank's shard of ``BatchIterator`` and
``BalancedBatchIterator`` against JAX's stacked leaves ``[rank]`` (bit for
bit, at 2 and 3 devices, with a batch that 3 does not divide); the bf16
compression against ``repro.optim.grad``; the collectives over 2 gloo
ranks (bucketed equal to plain, JAX's greedy bucket rule, the bf16 sum,
the stack over ranks and the metric mean exact); the DP train steps for
each ``grad_reduce``, the accumulation over a balanced plan, the DP eval
and serve steps and ``elastic_train`` with a device drop, at 2 gloo ranks
against the JAX package's ``shard_map`` steps over 2 forced host devices
(one subprocess, its XLA CPU codegen at optimization level 0 to cut the
compile time), with the replicas equal bit for bit after every step; a
one-rank mesh equal to no mesh; the decisions the ranks must agree on
(the refit's times, a SIGTERM to one rank, a checkpoint of 2 ranks
restored at 1); and ``--devices 2`` in the launcher.

The port runs FAST_FUSED's kernels' path (their plain versions on the
CPU), the JAX side its unfused twin FAST_FS_HEAD, as in
tests/test_torch_train.py.  The ranks are spawned processes that import
nothing of JAX (this module's top level imports only the port).  The
JAX subprocess and the ranks start before the first test and run while
the in-process tests do; the tests that read them come last.  Every
spawn and subprocess has its own timeout."""
import dataclasses
import hashlib
import itertools
import json
import math
import os
import queue
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.batching import ladder_for  # noqa: E402
from repro_torch.configs import chgnet_mptrj as TC  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.chgnet import chgnet_init  # noqa: E402
from repro_torch.core.graph import FIELDS  # noqa: E402
from repro_torch.data import (  # noqa: E402
    BalancedBatchIterator,
    BatchIterator,
    SyntheticConfig,
    make_dataset,
)
from repro_torch.distributed import (  # noqa: E402
    DataMesh,
    bucket_plan,
    bucketed_all_reduce,
    compressed_all_reduce,
    init_data_mesh,
    mean_metrics,
    stack_over_ranks,
)
from repro_torch.optim import grad as tgrad  # noqa: E402
from repro_torch.optim.adam import adam_init  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ChaosMonkey,
    ChaosSchedule,
    DeviceDropInjector,
    GracefulShutdown,
    PreemptionError,
    elastic_restore,
    elastic_train,
    per_device_batch,
    read_resume_marker,
    reshard,
)
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.train import trainer as ttrain  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(dim=16, num_blocks=1, num_rbf=7, num_fourier=7)
TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_train.py's tolerance
SYN = dict(num_crystals=32, max_atoms=12, seed=0)
CFG = TC.FAST_FUSED.with_(**SMALL)
REDUCE = ("plain", "bucketed", "compressed")
TIMEOUT = 240  # seconds, for each spawn and subprocess


def _tcfg(**kw) -> TrainConfig:
    return TrainConfig(global_batch=8, total_steps=64, lr_k=1, loss=TC.LOSS,
                       **kw)


def _digest(tree) -> str:
    """sha256 of every leaf's bytes, in leaf order: equal digests are
    equal trees, bit for bit."""
    h = hashlib.sha256()
    for x in leaves(tree):
        h.update(x.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _trainer(jparams, mesh, **kw) -> Trainer:
    """A mesh Trainer from the JAX package's initial parameters."""
    tr = Trainer(CFG, _tcfg(**kw.pop("train", {})), mesh=mesh, **kw)
    tr.params = ttrain.params_on(params_from_numpy(jparams), mesh.device)
    tr.opt_state = adam_init(tr.params)
    return tr


def _steps(tr, batches, n: int) -> tuple[list, list]:
    """n single steps of ``tr`` over ``batches``: the history and the
    state's digest after each step."""
    hist, digests = [], []
    for _ in range(n):
        hist += tr.train(itertools.islice(batches, 1))
        digests.append(_digest(tr.state()))
    return hist, digests


# ---------------------------------------------------------------------------
# the ranks' side (spawned processes: torch and the port only)
# ---------------------------------------------------------------------------

def _leaf_inputs(rank: int) -> list:
    """A tree of gradient-like leaves, different on each rank."""
    rng = np.random.default_rng(100 + rank)
    shapes = [(3, 5), (64,), (1,), (7, 7, 2), (300,), (2, 33)]
    return [torch.from_numpy(rng.normal(0, 3, s).astype(np.float32))
            for s in shapes]


def _rank_collectives(mesh: DataMesh) -> dict:
    plain = [mesh.all_reduce(x) for x in _leaf_inputs(mesh.rank)]
    res = {"bucketed_equals_plain": [], "buckets": {}}
    for nbytes in (4 << 20, 1200, 256, 1):
        got = bucketed_all_reduce(_leaf_inputs(mesh.rank), mesh, nbytes)
        res["bucketed_equals_plain"].append(
            all(torch.equal(a, b) for a, b in zip(got, plain)))
        res["buckets"][nbytes] = len(bucket_plan(got, nbytes))
    res["compressed"] = [x.numpy() for x in compressed_all_reduce(
        _leaf_inputs(mesh.rank), mesh)]
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * mesh.rank
    res["stacked"] = stack_over_ranks({"x": x}, mesh)["x"].numpy()
    res["mean"] = {k: float(v) for k, v in mean_metrics(
        {"a": torch.tensor(1.25 + mesh.rank), "b": torch.tensor(-3.0)},
        mesh).items()}
    same = {"w": [torch.arange(3.0)], "n": torch.tensor(7, dtype=torch.int32)}
    res["reshard_equal"] = all(torch.equal(a, b) for a, b in zip(
        leaves(reshard(same, mesh)), leaves(same)))
    try:
        reshard({"w": torch.tensor([float(mesh.rank)])}, mesh)
        res["reshard_differs_raises"] = False
    except ValueError:
        res["reshard_differs_raises"] = True
    return res


def _rank_train(mesh, jparams, ds, caps) -> dict:
    res = {}
    for how in REDUCE:
        tr = _trainer(jparams, mesh, train={"grad_reduce": how})
        res[how] = _steps(tr, iter(BatchIterator(ds, 8, 2, caps, seed=1,
                                                 shard=mesh.rank)), 2)
    tr = _trainer(jparams, mesh)
    res["accum"] = _steps(tr, iter(BalancedBatchIterator(
        ds, 8, 2, caps, num_micro=2, seed=2, shard=mesh.rank)), 2)
    tr = _trainer(jparams, mesh)
    batch = next(iter(BatchIterator(ds, 8, 2, caps, seed=9,
                                    shard=mesh.rank)))
    res["eval"] = tr.evaluate(batch)
    res["serve"] = {k: v.numpy() for k, v in tr.serve(batch).items()}
    return res


def _rank_refit(mesh, jparams, ds, caps) -> dict:
    """Rank 1 sleeps 50 ms in every microbatch: both ranks must record the
    slow rank's times and fit the same model."""
    tr = _trainer(jparams, mesh, train={"cost_refit_every": 2,
                                        "cost_refit_warmup": 0})
    if mesh.rank == 1:
        grad_step = tr._grad_step

        def slow(*args):
            time.sleep(0.05)
            return grad_step(*args)

        tr._grad_step = slow
    tr.train(itertools.islice(BalancedBatchIterator(
        ds, 8, 2, caps, num_micro=2, seed=3, shard=mesh.rank), 2))
    return {"times": [t for _, t in tr._cost_samples],
            "model": dataclasses.asdict(tr.cost_model)}


def _rank_sigterm(mesh, jparams, ds, caps, ckpt_dir: str) -> dict:
    """A real SIGTERM to rank 1 before step 2: both ranks must preempt at
    the same step, and rank 0 alone write the checkpoint and marker."""
    writes = []
    save, marker = ttrain.save_checkpoint, ttrain.write_resume_marker
    ttrain.save_checkpoint = lambda *a, **k: (writes.append("ckpt"),
                                              save(*a, **k))
    ttrain.write_resume_marker = lambda *a, **k: (writes.append("marker"),
                                                  marker(*a, **k))
    monkey = ChaosMonkey(ChaosSchedule.parse("sigterm@2")) \
        if mesh.rank == 1 else None
    try:
        with GracefulShutdown() as shutdown:
            tr = _trainer(jparams, mesh, ckpt_dir=ckpt_dir, ckpt_every=100,
                          shutdown=shutdown)
            try:
                tr.train(BatchIterator(ds, 8, 2, caps, seed=4,
                                       shard=mesh.rank),
                         fault_injector=monkey)
                preempted = None
            except PreemptionError as exc:
                preempted = exc.step
    finally:
        ttrain.save_checkpoint, ttrain.write_resume_marker = save, marker
    return {"preempted": preempted, "writes": writes,
            "digest": _digest(tr.state())}


def _rank_elastic(mesh, jparams, ds, caps) -> dict:
    tr = _trainer(jparams, mesh)
    _, eval_step, _ = ttrain.make_chgnet_step_fns(CFG, _tcfg())
    held = next(iter(BatchIterator(ds, 8, 1, caps, seed=99)))
    before = float(eval_step(tr.params, held)["loss"])
    digests = []

    def batches_fn(num_devices):
        it = BalancedBatchIterator(ds, 8, num_devices, caps, num_micro=2,
                                   seed=5, shard=tr.mesh.rank)
        for plan in itertools.islice(itertools.cycle(iter(it)), 8):
            yield plan
            digests.append((tr.step, _digest(tr.state())))

    hist = elastic_train(tr, batches_fn, max_steps=8,
                         fault_injector=DeviceDropInjector(5, 1))
    return {"history": hist, "steps": tr.step, "devices": tr.num_devices,
            "before": before, "digests": digests,
            "after": float(eval_step(tr.params, held)["loss"])}


def _rank_main(rank: int, world: int, init_method: str, jparams,
               ckpt_dir: str, results) -> None:
    torch.set_num_threads(1)
    mesh = init_data_mesh("cpu", rank=rank, world_size=world,
                          init_method=init_method)
    try:
        ds = make_dataset(SyntheticConfig(**SYN))
        caps = ladder_for(ds, 8)
        res = {"collectives": _rank_collectives(mesh)}
        res.update(_rank_train(mesh, jparams, ds, caps))
        res["refit"] = _rank_refit(mesh, jparams, ds, caps)
        res["sigterm"] = _rank_sigterm(mesh, jparams, ds, caps, ckpt_dir)
        res["elastic"] = _rank_elastic(mesh, jparams, ds, caps)
        results.put((rank, res))
    except BaseException as exc:
        results.put((rank, repr(exc)))
        raise
    finally:
        dist.destroy_process_group()


def _start_ranks(world: int, jparams, tmp: Path):
    """Start ``_rank_main`` on ``world`` gloo ranks (``_collect_ranks``
    waits for them)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, f"file://{tmp}/store", jparams, str(tmp / "ckpt"),
        results), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs, results


def _collect_ranks(procs, results, deadline: float) -> list:
    """The ranks' results in rank order; every rank still running at
    ``deadline`` (``time.monotonic``) is killed."""
    out: dict = {}
    try:
        while len(out) < len(procs):
            try:
                rank, res = results.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                break
            out[rank] = res
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    errors = {r: v for r, v in out.items() if isinstance(v, str)}
    assert not errors and len(out) == len(procs), \
        f"ranks failed or timed out: {errors or sorted(out)}; exit codes " \
        f"{[p.exitcode for p in procs]}"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [out[r] for r in range(len(procs))]


# ---------------------------------------------------------------------------
# the JAX package's side (a subprocess with 2 forced host devices)
# ---------------------------------------------------------------------------

_JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=2 "
        "--xla_backend_optimization_level=0 "
        "--xla_llvm_disable_expensive_passes=true")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import itertools, json, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.batching import ladder_for
    from repro.configs import chgnet_mptrj as JC
    from repro.data import (BalancedBatchIterator, BatchIterator,
                            SyntheticConfig, make_dataset)
    from repro.runtime import DeviceDropInjector, elastic_train
    from repro.train import TrainConfig, Trainer
    from repro.train.trainer import make_chgnet_step_fns

    syn, small, out = json.loads(sys.argv[1]), json.loads(sys.argv[2]), \\
        sys.argv[3]
    ds = make_dataset(SyntheticConfig(**syn))
    caps = ladder_for(ds, 8)
    mesh = Mesh(np.array(jax.devices()), ("data",))
    assert mesh.devices.size == 2
    cfg = JC.FAST_FS_HEAD.with_(**small)

    def tcfg(**kw):
        return TrainConfig(global_batch=8, total_steps=64, lr_k=1,
                           loss=JC.LOSS, **kw)

    def hist(h):
        return [{k: float(v) for k, v in s.items()} for s in h]

    res = {}
    for how in ("plain", "bucketed", "compressed"):
        tr = Trainer(cfg, tcfg(grad_reduce=how), mesh=mesh)
        res[how] = hist(tr.train(BatchIterator(ds, 8, 2, caps, seed=1),
                                 max_steps=2))
    tr = Trainer(cfg, tcfg(), mesh=mesh)
    res["accum"] = hist(tr.train(BalancedBatchIterator(
        ds, 8, 2, caps, num_micro=2, seed=2, stack=True), max_steps=2))
    tr = Trainer(cfg, tcfg(), mesh=mesh)
    batch = next(iter(BatchIterator(ds, 8, 2, caps, seed=9)))
    res["eval"] = tr.evaluate(batch)
    np.savez(out, **jax.tree.map(np.asarray, tr.serve(batch)))

    tr = Trainer(cfg, tcfg(), mesh=mesh)
    _, eval_step, _ = make_chgnet_step_fns(cfg, tcfg())
    held = next(iter(BatchIterator(ds, 8, 1, caps, seed=99)))
    before = float(eval_step(jax.device_get(tr.params), held)["loss"])

    def batches_fn(num_devices):
        it = BalancedBatchIterator(ds, 8, num_devices, caps, num_micro=2,
                                   stack=True, seed=5)
        return itertools.islice(itertools.cycle(iter(it)), 8)

    h = elastic_train(tr, batches_fn, max_steps=8,
                      fault_injector=DeviceDropInjector(5, 1))
    res["elastic"] = {
        "history": hist(h), "steps": tr.step, "devices": tr.num_devices,
        "before": before,
        "after": float(eval_step(jax.device_get(tr.params), held)["loss"])}
    print(json.dumps(res))
""")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this process, as tests/test_torch_balance.py
    does: beside the ranks and the JAX subprocess, and several test
    workers, a pool of spinning threads only oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _background(tmp_path_factory):
    """Starts, before this module's first test, the JAX subprocess (2
    forced host devices) and the 2 torch ranks, from the same initial
    parameters; they run while the in-process tests do, and ``ranks`` /
    ``jax_results`` wait for them, within ``TIMEOUT`` of the start.
    Whatever still runs at the module's end is killed."""
    import jax

    from repro.configs import chgnet_mptrj as JC
    from repro.core.chgnet import chgnet_init as j_init

    tmp = tmp_path_factory.mktemp("dp")
    deadline = time.monotonic() + TIMEOUT
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    with open(tmp / "jax.out", "w") as out, open(tmp / "jax.err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_SCRIPT, json.dumps(SYN),
             json.dumps(SMALL), str(tmp / "serve.npz")],
            stdout=out, stderr=err, env=env, cwd=ROOT)
    jparams = jax.tree.map(np.asarray, j_init(
        jax.random.PRNGKey(0), JC.FAST_FS_HEAD.with_(**SMALL)))
    procs, results = _start_ranks(2, jparams, tmp)
    yield {"tmp": tmp, "deadline": deadline, "jax": proc, "procs": procs,
           "results": results}
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)


@pytest.fixture(scope="module")
def ranks(_background):
    """Rank 0's and rank 1's results."""
    return _collect_ranks(_background["procs"], _background["results"],
                          _background["deadline"])


@pytest.fixture(scope="module")
def jax_results(_background):
    """``(results, serve outputs)`` of the JAX subprocess."""
    proc, tmp = _background["jax"], _background["tmp"]
    try:
        proc.wait(timeout=max(_background["deadline"] - time.monotonic(),
                              0.1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    err = (tmp / "jax.err").read_text()
    assert proc.returncode == 0, err[-3000:]
    out = (tmp / "jax.out").read_text()
    return (json.loads(out.strip().splitlines()[-1]),
            dict(np.load(tmp / "serve.npz")))


# ---------------------------------------------------------------------------
# 1-2. sharded batches and the compression, in process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def datasets():
    from repro.data import SyntheticConfig as JSyn
    from repro.data import make_dataset as j_dataset

    return j_dataset(JSyn(**SYN)), make_dataset(SyntheticConfig(**SYN))


def _assert_shard(tb, jb, rank: int, what: str) -> None:
    for k in FIELDS:
        want = np.asarray(getattr(jb, k))[rank]
        got = getattr(tb, k).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), \
            f"{what} rank {rank} field {k}"


@pytest.mark.parametrize("num_devices", [2, 3])
@pytest.mark.parametrize("load_balance", [True, "cost"])
def test_batch_iterator_shards_equal_jax_stacked_leaves(
        datasets, load_balance, num_devices):
    """Rank r's shard (``shard=r``) is JAX's ``stack=True`` leaves ``[r]``
    in all 35 fields, with the same global tags; ``shard=None`` gives every
    shard.  Batch 8 does not divide by 3."""
    from repro.batching import ladder_for as j_ladder
    from repro.data import BatchIterator as JIter

    jds, tds = datasets
    jit = JIter(jds, 8, num_devices, j_ladder(jds, 8),
                load_balance=load_balance, seed=1, stack=True,
                tag_indices=True)
    tcaps = ladder_for(tds, 8)
    ranks = [BatchIterator(tds, 8, num_devices, tcaps, seed=1,
                           load_balance=load_balance, tag_indices=True,
                           shard=r) for r in range(num_devices)]
    every = BatchIterator(tds, 8, num_devices, tcaps, seed=1,
                          load_balance=load_balance)
    n = 0
    for jb, all_shards, *tbs in zip(jit, every, *ranks):
        assert len(all_shards) == num_devices
        for r, tb in enumerate(tbs):
            np.testing.assert_array_equal(tb.indices, jb.indices)
            _assert_shard(tb.batch, jb.batch, r, "shard")
            _assert_shard(all_shards[r], jb.batch, r, "shard=None")
        n += 1
    assert n == 4
    assert ranks[0].crystal_slots == jit.crystal_slots


@pytest.mark.parametrize("num_micro", [1, 2])
def test_balanced_plans_shard_equal_jax_stacked_leaves(datasets, num_micro):
    """Each rank's column of a plan is JAX's stacked microbatches ``[r]``,
    with the global denominators and the microbatches' real sizes over
    all shards; ``shard=None`` gives each microbatch's shards."""
    from repro.batching import ladder_for as j_ladder
    from repro.data import BalancedBatchIterator as JBalanced

    jds, tds = datasets
    jit = JBalanced(jds, 8, 2, j_ladder(jds, 8), num_micro=num_micro,
                    seed=4, stack=True)
    tcaps = ladder_for(tds, 8)
    ranks = [BalancedBatchIterator(tds, 8, 2, tcaps, num_micro=num_micro,
                                   seed=4, shard=r) for r in range(2)]
    every = BalancedBatchIterator(tds, 8, 2, tcaps, num_micro=num_micro,
                                  seed=4)
    n = 0
    for jp, all_plan, *tps in zip(jit, every, *ranks):
        for tp in tps + [all_plan]:
            assert {k: float(v) for k, v in tp.denoms.items()} == \
                {k: float(v) for k, v in jp.denoms.items()}
            np.testing.assert_array_equal(tp.micro_sizes, jp.micro_sizes)
            np.testing.assert_array_equal(tp.shard_costs, jp.shard_costs)
            assert tp.num_real == jp.num_real
            assert len(tp.micro) == len(jp.micro) == num_micro
        for m, jm in enumerate(jp.micro):
            for r in range(2):
                _assert_shard(tps[r].micro[m], jm, r, f"micro {m}")
                _assert_shard(all_plan.micro[m][r], jm, r, "shard=None")
        n += 1
    assert n == 4


def test_idle_rank_gets_an_all_padding_shard(datasets):
    """A microbatch with fewer crystals than devices leaves a rank idle:
    its shard is all padding, as JAX's, and adds exact zeros (its loss
    sums and every gradient leaf)."""
    from repro.batching import ladder_for as j_ladder
    from repro.data import BalancedBatchIterator as JBalanced

    jds, tds = datasets
    idx = np.array([3, 11])
    (jm,) = JBalanced(jds, 3, 3, j_ladder(jds, 8), stack=True) \
        .plan_step(idx).micro
    plans = [BalancedBatchIterator(tds, 3, 3, ladder_for(tds, 8),
                                   shard=r).plan_step(idx) for r in range(3)]
    for r, plan in enumerate(plans):
        _assert_shard(plan.micro[0], jm, r, "micro 0")
    idle = plans[2].micro[0]
    assert not bool(idle.atom_mask.any()) and not bool(idle.bond_mask.any())
    grad_step, _ = ttrain.make_chgnet_accum_step_fns(CFG, _tcfg())
    grads, sums = grad_step(ttrain.params_on(chgnet_init(0, CFG), "cpu"),
                            idle, plans[2].denoms)
    assert all(float(v) == 0.0 for v in sums.values())
    assert all(not bool(g.any()) for g in grads)


def test_compress_decompress_ef_match_jax():
    import jax
    import jax.numpy as jnp

    from repro.optim import grad as jgrad

    rng = np.random.default_rng(0)
    g = {"a": rng.normal(0, 1, (5, 3)).astype(np.float32),
         "b": [rng.normal(0, 1e-3, 7).astype(np.float32)]}
    jg = jax.tree.map(jnp.asarray, g)
    tg = params_from_numpy(g)
    jef = jgrad.ef_init(jg)
    tef = tgrad.ef_init(tg)
    assert [x.shape for x in leaves(tef)] == \
        [x.shape for x in jax.tree.leaves(jef)]
    assert all(not bool(x.any()) for x in leaves(tef))
    for _ in range(2):  # the residual carries into the second round
        jq, jef = jgrad.compress(jg, jef)
        tq, tef = tgrad.compress(tg, tef)
        for a, b in zip(tq, jax.tree.leaves(jq)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
        for a, b in zip(tef, jax.tree.leaves(jef)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tgrad.decompress(tq),
                        jax.tree.leaves(jgrad.decompress(jq))):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    q, none = tgrad.compress(tg)
    assert none is None and q[0].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# 3. a one-rank mesh, in process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo group of one rank in this process."""
    mesh = init_data_mesh("cpu", rank=0, world_size=1, init_method=(
        f"file://{tmp_path_factory.mktemp('one')}/store"))
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("how", REDUCE)
def test_one_rank_mesh_equals_no_mesh(one_rank, datasets, how):
    """Three steps on a mesh of one bit for bit those of the single-device
    Trainer (plain and bucketed: an all-reduce of one rank is a copy and
    /1 is exact; compressed: the same bits after a bf16 rounding of each
    gradient, so only its first loss is equal), then a balanced plan
    through ``_step_plan``; the mesh Trainer evaluates and serves
    (tests/test_trainer_e2e.py)."""
    _, ds = datasets
    caps = ladder_for(ds, 8)
    a = Trainer(CFG, _tcfg(grad_reduce=how), seed=3, device="cpu")
    b = Trainer(CFG, _tcfg(grad_reduce=how), seed=3, mesh=one_rank)
    assert b.num_devices == 1 and b.device == torch.device("cpu")
    ha = a.train(BatchIterator(ds, 8, 1, caps, seed=7), max_steps=3)
    hb = b.train(BatchIterator(ds, 8, 1, caps, seed=7, shard=0),
                 max_steps=3)
    if how == "compressed":
        # the same first loss; then TOL, the gradient norm at DESIGN.md
        # §4's 5% (a bf16 rounding of every gradient)
        assert ha[0]["loss"] == hb[0]["loss"]
        for g, w in zip(hb, ha):
            np.testing.assert_allclose(g.pop("grad_norm"),
                                       w.pop("grad_norm"), rtol=0.05)
        _assert_history(hb, ha, how)
        return
    assert ha == hb and _digest(a.state()) == _digest(b.state())
    ha = a.train(BalancedBatchIterator(ds, 8, 1, caps, num_micro=2,
                                       seed=1), max_steps=5)
    hb = b.train(BalancedBatchIterator(ds, 8, 1, caps, num_micro=2, seed=1,
                                       shard=0), max_steps=5)
    assert ha == hb and _digest(a.state()) == _digest(b.state())
    batch = next(iter(BatchIterator(ds, 8, 1, caps, seed=2)))
    assert b.evaluate(batch) == a.evaluate(batch)
    out, want = b.serve(batch), a.serve(batch)
    assert set(out) == {"energy", "forces", "stress", "magmom"}
    for k in out:
        assert out[k].shape == (1, *want[k].shape)
        assert torch.equal(out[k][0], want[k])


def test_mesh_checks(one_rank):
    with pytest.raises(ValueError, match="out of range"):
        one_rank.surviving(1)
    with pytest.raises(ValueError, match="no surviving"):
        one_rank.surviving(0)
    with pytest.raises(ValueError, match="mesh's device"):
        Trainer(CFG, _tcfg(), mesh=one_rank, device="meta")
    with pytest.raises(ValueError, match="shard 2 out of range"):
        BatchIterator(make_dataset(SyntheticConfig(**SYN)), 8, 2,
                      ladder_for(make_dataset(SyntheticConfig(**SYN)), 8),
                      shard=2)


# ---------------------------------------------------------------------------
# 4. the launcher
# ---------------------------------------------------------------------------

def test_launcher_devices_trains_resumes_and_refuses(tmp_path):
    """``--device cpu --devices 2`` spawns 2 gloo ranks and trains the
    balanced path through elastic_train with async checkpoints: position 1
    is dropped at step 1 (chaos ``drop@1:1``) and leaves, rank 0 goes on
    alone to step 2; then both resume from rank 0's checkpoint to step 3
    (a subprocess each, bounded in time).  ``--devices 2`` on cuda without
    2 GPUs raises before spawning."""
    from repro_torch.launch import train as launch
    from repro_torch.runtime import latest_valid_step

    d = str(tmp_path / "ckpt")
    common = ["--device", "cpu", "--devices", "2", "--batch", "4",
              "--crystals", "8", "--balance", "cost", "--accum", "2",
              "--conv-impl", "fused", "--ckpt", d, "--ckpt-every", "2",
              "--async-ckpt"]
    # one intra-op thread a rank (the launcher splits the process's)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    for steps, extra in ((2, ["--chaos", "drop@1:1"]), (3, [])):
        argv = ["--steps", str(steps)] + common + extra
        code = ("import sys\nfrom repro_torch.launch import train\n"
                f"sys.exit(train.main({argv!r}) != {steps})")
        proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
        assert proc.returncode == 0, out[-2000:] + err[-3000:]
        assert latest_valid_step(d) == steps
        assert "devices=2" in out and out.count("device=cpu") == 1
    assert f"restored step 2 from {d}" in out
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="--devices 2 needs"):
            launch.main(["--devices", "2", "--steps", "1"])


# ---------------------------------------------------------------------------
# 5. collectives at 2 gloo ranks (the background ranks)
# ---------------------------------------------------------------------------

def _jax_bucket_count(shapes, nbytes: int, monkeypatch) -> int:
    """How many ``psum`` calls (one a bucket) ``repro.distributed.
    collectives.bucketed_psum`` makes for leaves of these shapes, traced
    under an axis of 2."""
    import jax
    import jax.numpy as jnp

    from repro.distributed.collectives import bucketed_psum

    calls = []
    psum = jax.lax.psum
    monkeypatch.setattr(jax.lax, "psum",
                        lambda x, axis: calls.append(1) or psum(x, axis))
    jax.make_jaxpr(lambda t: bucketed_psum(t, "i", bucket_bytes=nbytes),
                   axis_env=[("i", 2)])([jnp.zeros(s, jnp.float32)
                                         for s in shapes])
    monkeypatch.setattr(jax.lax, "psum", psum)
    return len(calls)


def test_collectives_at_two_ranks(ranks, monkeypatch):
    ranks = [r["collectives"] for r in ranks]
    a, b = _leaf_inputs(0), _leaf_inputs(1)
    shapes = [tuple(x.shape) for x in a]
    for res in ranks:
        assert all(res["bucketed_equals_plain"])
        for nbytes, count in res["buckets"].items():
            assert count == _jax_bucket_count(shapes, nbytes,
                                              monkeypatch), nbytes
        assert res["buckets"][4 << 20] == 1 and res["buckets"][1] == 6
        # the bf16 sum of the bf16-rounded inputs, cast to f32
        for got, x, y in zip(res["compressed"], a, b):
            want = (x.to(torch.bfloat16) + y.to(torch.bfloat16)).float()
            np.testing.assert_array_equal(got, want.numpy())
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        np.testing.assert_array_equal(res["stacked"],
                                      np.stack([x, x + 10]))
        assert res["mean"] == {"a": 1.75, "b": -3.0}
        assert res["reshard_equal"]
    # reshard checks every replica against rank 0's
    assert [r["reshard_differs_raises"] for r in ranks] == [False, True]


# ---------------------------------------------------------------------------
# 6. decisions the ranks agree on
# ---------------------------------------------------------------------------

def test_refit_takes_the_slowest_ranks_times(ranks):
    r0, r1 = (r["refit"] for r in ranks)
    assert len(r0["times"]) == 4 and r0["times"] == r1["times"]
    assert min(r0["times"]) >= 0.05
    assert r0["model"] == r1["model"]


def test_sigterm_to_one_rank_stops_both_and_rank0_writes(ranks,
                                                         _background):
    from repro_torch.runtime import latest_valid_step

    s0, s1 = (r["sigterm"] for r in ranks)
    ckpt = str(_background["tmp"] / "ckpt")
    assert s0["preempted"] == s1["preempted"] == 3
    assert s0["writes"] == ["ckpt", "marker"] and s1["writes"] == []
    assert s0["digest"] == s1["digest"]
    assert latest_valid_step(ckpt) == 3
    assert read_resume_marker(ckpt)["step"] == 3


def test_two_rank_checkpoint_restores_at_one(ranks, _background,
                                             one_rank):
    """The checkpoint rank 0 wrote for both ranks restores on a mesh of
    one through ``elastic_restore``, bit for bit the ranks' state."""
    tr = Trainer(CFG, _tcfg(), mesh=one_rank)
    tree, step, meta = elastic_restore(str(_background["tmp"] / "ckpt"),
                                       tr.state(), one_rank)
    assert step == 3 and "model_cfg" in meta
    assert _digest(tree) == ranks[0]["sigterm"]["digest"]
    assert per_device_batch(2048, 32) == 64
    with pytest.raises(ValueError, match="not divisible"):
        per_device_batch(10, 3)


# ---------------------------------------------------------------------------
# 7. the DP steps at 2 ranks against JAX's shard_map at 2 host devices
# (last: the JAX subprocess has had the other tests' time)
# ---------------------------------------------------------------------------

def _assert_history(got: list, want: list, what: str) -> None:
    assert len(got) == len(want), what
    for s, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{what} {s} {k}",
                                       **TOL)
        assert math.isfinite(g.get("grad_norm", 0.0))


@pytest.mark.parametrize("how", REDUCE + ("accum",))
def test_dp_train_steps_match_jax(ranks, jax_results, how):
    """Every step's metrics at ``TOL`` of JAX's, the replicas equal bit for
    bit after every step; the compressed reduction's gradient norm within
    DESIGN.md §4's 5% of the f32 reduction's."""
    jres, _ = jax_results
    (h0, d0), (h1, d1) = ranks[0][how], ranks[1][how]
    assert d0 == d1, f"{how}: the replicas differ"
    assert h0 == h1
    _assert_history(h0, jres[how], how)
    if how == "compressed":
        f32 = ranks[0]["bucketed"][0][0]["grad_norm"]
        assert abs(h0[0]["grad_norm"] - f32) <= 0.05 * f32
    if how == "plain":
        assert ranks[0]["plain"] == ranks[0]["bucketed"]


def test_dp_eval_and_serve_match_jax(ranks, jax_results):
    jres, jserve = jax_results
    for r in ranks:
        for k, w in jres["eval"].items():
            np.testing.assert_allclose(r["eval"][k], w, err_msg=k, **TOL)
        assert set(r["serve"]) == set(jserve)
        for k, w in jserve.items():
            assert r["serve"][k].shape == w.shape  # leading device axis
            np.testing.assert_allclose(r["serve"][k], w, err_msg=k, **TOL)
            np.testing.assert_array_equal(r["serve"][k],
                                          ranks[0]["serve"][k])


def test_elastic_train_drops_a_rank_and_matches_jax(ranks, jax_results):
    """A drop of position 1 at step 5 of 8: rank 1 returns with its 5
    steps, rank 0 re-bin-packs alone and finishes; JAX's invariants
    (tests/test_balance.py): every step done, no history lost, one device
    left, the held-out loss lower; the metrics at ``TOL`` of JAX's, the
    replicas equal at every step both ran."""
    jres, _ = jax_results
    e0, e1 = ranks[0]["elastic"], ranks[1]["elastic"]
    want = jres["elastic"]
    assert e0["steps"] == want["steps"] == 8
    assert len(e0["history"]) == len(want["history"]) == 8
    assert e0["devices"] == want["devices"] == 1
    assert e1["steps"] == 5 and len(e1["history"]) == 5
    assert e0["after"] < e0["before"]
    np.testing.assert_allclose(e0["before"], want["before"], **TOL)
    np.testing.assert_allclose(e0["after"], want["after"], **TOL)
    _assert_history(e0["history"], want["history"], "elastic")
    assert e0["history"][:5] == e1["history"]
    assert e0["digests"][:5] == e1["digests"]
