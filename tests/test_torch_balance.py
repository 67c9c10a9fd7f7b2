"""The port's load balancer and accumulation over uneven capacity buckets
(DESIGN.md §6) against the JAX package on the CPU: the cost model and
its fit, LPT bin packing, ``plan_microbatches``, ``CostBalanceSampler``
and ``BalancedBatchIterator``'s plans (exact, seed for seed, at
``capacity_for`` and on the ladder, with quarantine), ``_step_plan``'s
metrics and updated parameters against JAX's ``Trainer._step_plan``
(``TOL`` in f32), two microbatches against one big batch (1e-6), the
mixed-precision skip across microbatches, the cost sampler's load
balance, and the Prefetcher on plans.  The port runs FAST_FUSED's
kernels' path (their plain versions on the CPU), the JAX side its
unfused twin FAST_FS_HEAD, as in tests/test_torch_train.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.batching import balance as jbal  # noqa: E402
from repro.batching import cost as jcost  # noqa: E402
from repro.batching import capacity_for as j_caps  # noqa: E402
from repro.batching import ladder_for as j_ladder  # noqa: E402
from repro.configs import chgnet_mptrj as JC  # noqa: E402
from repro.data import BalancedBatchIterator as JBalanced  # noqa: E402
from repro.data import BatchIterator as JIter  # noqa: E402
from repro.data import SyntheticConfig as JSyn  # noqa: E402
from repro.data import make_dataset as j_dataset  # noqa: E402
from repro.data import sampler as jsampler  # noqa: E402
from repro.train import trainer as jtrain  # noqa: E402
from repro_torch.batching import (  # noqa: E402
    DEFAULT_COST_MODEL,
    CostModel,
    StepPlan,
    capacity_for,
    crystal_slots_for,
    fit_cost_model,
    ladder_for,
    lpt_pack,
    plan_microbatches,
    shard_cost_totals,
    straggler_ratio,
)
from repro_torch.configs import chgnet_mptrj as TC  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.graph import FIELDS, CrystalGraphBatch  # noqa: E402
from repro_torch.data import (  # noqa: E402
    BalancedBatchIterator,
    BatchIterator,
    CostBalanceSampler,
    DefaultSampler,
    LoadBalanceSampler,
    Prefetcher,
    SyntheticConfig,
    TaggedBatch,
    cov_of_device_loads,
    device_loads,
    make_dataset,
)
from repro_torch.optim.adam import adam_init  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.train import trainer as ttrain  # noqa: E402

SMALL = dict(dim=16, num_blocks=1, num_rbf=7, num_fourier=7)
TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_train.py's tolerance
SYN = dict(num_crystals=48, max_atoms=14, seed=0)
CFG = TC.FAST_FUSED.with_(**SMALL)


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
def datasets():
    return j_dataset(JSyn(**SYN)), make_dataset(SyntheticConfig(**SYN))


@pytest.fixture(scope="module")
def ds(datasets):
    return datasets[1]


@pytest.fixture(scope="module")
def caps(ds):
    return ladder_for(ds, 8)


def _assert_batches_equal(jb, tb):
    for k in FIELDS:
        want, got = np.asarray(getattr(jb, k)), getattr(tb, k).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def _assert_plans_equal(jp, tp):
    assert len(tp.micro) == len(jp.micro)
    for jb, tb in zip(jp.micro, tp.micro):
        _assert_batches_equal(jb, tb)
    assert tp.denoms == jp.denoms
    for k in tp.denoms:
        assert type(tp.denoms[k]) is type(jp.denoms[k])
    np.testing.assert_array_equal(tp.shard_costs, jp.shard_costs)
    np.testing.assert_array_equal(tp.micro_sizes, jp.micro_sizes)
    assert tp.num_real == jp.num_real
    assert tp.straggler == jp.straggler


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# cost model (tests/test_balance.py), exact against JAX
# ---------------------------------------------------------------------------

def test_cost_model_fit_recovers_affine_coefficients():
    rng = np.random.default_rng(0)
    counts = rng.integers(1, 200, size=(64, 3)).astype(np.float64)
    true = CostModel(c0=3.0, atoms=0.5, bonds=1.5, angles=0.25)
    times = (true.c0 + counts @ np.array([true.atoms, true.bonds,
                                          true.angles]))
    fit = fit_cost_model(counts, times)
    np.testing.assert_allclose(
        [fit.c0, fit.atoms, fit.bonds, fit.angles],
        [true.c0, true.atoms, true.bonds, true.angles], atol=1e-6)


def test_cost_model_fit_clamps_nonnegative():
    counts = np.array([[1.0, 10.0, 5.0], [2.0, 20.0, 9.0],
                       [3.0, 30.0, 2.0], [4.0, 40.0, 7.0]])
    times = counts[:, 1] * 2.0 - counts[:, 2] * 5.0 + 100.0
    fit = fit_cost_model(counts, times)
    assert fit.atoms >= 0 and fit.bonds >= 0 and fit.angles >= 0


@pytest.mark.parametrize("seed,intercept", [(0, True), (1, True),
                                            (2, False)])
def test_fit_cost_model_equals_jax(seed, intercept):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 5000, size=(12, 3)).astype(np.float64)
    times = rng.uniform(1e-3, 5e-2, size=12)
    got = fit_cost_model(sizes, times, keep_intercept=intercept)
    want = jcost.fit_cost_model(sizes, times, keep_intercept=intercept)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError):
        fit_cost_model(sizes[:, :2], times)
    with pytest.raises(ValueError):
        fit_cost_model(sizes, times[:-1])


def test_default_cost_model_is_feature_count(datasets):
    jds, ds = datasets
    costs = DEFAULT_COST_MODEL.predict_dataset(ds)
    np.testing.assert_array_equal(costs, ds.feature_counts())
    np.testing.assert_array_equal(
        costs, jcost.DEFAULT_COST_MODEL.predict_dataset(jds))
    model = CostModel(c0=1.5, atoms=0.25, bonds=2.0, angles=0.125)
    np.testing.assert_array_equal(
        model.predict_dataset(ds),
        jcost.CostModel(**dataclasses.asdict(model)).predict_dataset(jds))


# ---------------------------------------------------------------------------
# LPT bin packing and microbatch plans, exact against JAX
# ---------------------------------------------------------------------------

def test_lpt_pack_partition_and_determinism():
    rng = np.random.default_rng(1)
    costs = rng.lognormal(2.0, 1.0, size=37)
    a = lpt_pack(costs, 4, max_items=12)
    b = lpt_pack(costs, 4, max_items=12)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    flat = np.sort(np.concatenate(a))
    np.testing.assert_array_equal(flat, np.arange(37))
    assert max(len(s) for s in a) <= 12
    naive = np.array_split(np.arange(37), 4)
    assert (straggler_ratio(shard_cost_totals(costs, list(a)))
            <= straggler_ratio(shard_cost_totals(costs, naive)))
    with pytest.raises(ValueError):
        lpt_pack(costs, 0)
    with pytest.raises(ValueError):
        lpt_pack(costs, 4, max_items=9)


@pytest.mark.parametrize("n,bins,max_items,ties", [
    (37, 4, 12, False), (37, 4, None, False), (64, 8, 9, True),
    (5, 8, None, False), (1, 1, None, False), (40, 3, 14, True)])
def test_lpt_pack_equals_jax(n, bins, max_items, ties):
    rng = np.random.default_rng(n + bins)
    costs = rng.lognormal(2.0, 1.0, size=n)
    if ties:  # equal costs and equal loads: the tie-break rules decide
        costs = np.round(costs)
    got = lpt_pack(costs, bins, max_items=max_items)
    want = jbal.lpt_pack(costs, bins, max_items=max_items)
    assert len(got) == len(want) == bins
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,devices,micro", [
    (24, 2, 3), (24, 1, 2), (128, 1, 2), (7, 4, 3), (9, 1, 4), (3, 1, 5)])
def test_plan_microbatches_equals_jax(n, devices, micro):
    rng = np.random.default_rng(3 + n)
    costs = rng.lognormal(2.0, 1.0, size=n)
    slots = crystal_slots_for(n, devices, num_micro=micro)
    assert slots == jbal.crystal_slots_for(n, devices, num_micro=micro)
    got = plan_microbatches(costs, devices, micro, max_items=slots)
    want = jbal.plan_microbatches(costs, devices, micro, max_items=slots)
    assert len(got) == len(want)
    for gm, wm in zip(got, want):
        assert len(gm) == len(wm) == devices
        for g, w in zip(gm, wm):
            np.testing.assert_array_equal(g, w)
    seen = np.sort(np.concatenate([np.concatenate(m) for m in got]))
    np.testing.assert_array_equal(seen, np.arange(n))
    with pytest.raises(ValueError):
        plan_microbatches(costs, devices, 0)


def test_step_plan_straggler_property():
    plan = StepPlan(micro=[], denoms={},
                    shard_costs=np.array([[3.0, 1.0], [2.0, 2.0]]),
                    num_real=4)
    assert plan.straggler == pytest.approx(5.0 / 4.0)
    assert straggler_ratio(np.zeros(3)) == 1.0


# ---------------------------------------------------------------------------
# samplers (tests/test_balance.py, test_sampler_pipeline.py)
# ---------------------------------------------------------------------------

def test_cost_balance_sampler_seeded_determinism_and_jax():
    rng = np.random.default_rng(2)
    costs = rng.lognormal(2.0, 1.0, size=64)
    runs = []
    for _ in range(2):
        sampler = CostBalanceSampler(costs, seed=7, max_items=10)
        runs.append([(idx.tolist(), [s.tolist() for s in shards])
                     for idx, shards in sampler.epoch(16, 4)])
    assert runs[0] == runs[1]
    other = CostBalanceSampler(costs, seed=8, max_items=10)
    alt = [(i.tolist(), [s.tolist() for s in sh])
           for i, sh in other.epoch(16, 4)]
    assert alt != runs[0]
    for drop_last in (True, False):
        want = [(i.tolist(), [s.tolist() for s in sh]) for i, sh in
                jsampler.CostBalanceSampler(costs, seed=7, max_items=10)
                .epoch(12, 4, drop_last=drop_last)]
        got = [(i.tolist(), [s.tolist() for s in sh]) for i, sh in
               CostBalanceSampler(costs, seed=7, max_items=10)
               .epoch(12, 4, drop_last=drop_last)]
        assert got == want


def test_cov_reduction_matches_paper():
    """Paper Fig. 9: CoV 0.186 -> 0.064 (batch 32, 4 devices); the cost
    sampler balances predicted cost at least as tightly, and every CoV
    equals the JAX package's."""
    ds = make_dataset(SyntheticConfig(num_crystals=128, max_atoms=48,
                                      seed=0))
    counts = ds.feature_counts()
    assert counts.max() > 3 * np.median(counts)  # the long tail (Fig. 5)
    cov = {"default": [], "pair": [], "cost": []}
    for (_, sd), (_, sp), (_, sc) in zip(
            DefaultSampler(counts, 0).epoch(32, 4),
            LoadBalanceSampler(counts, 0).epoch(32, 4),
            CostBalanceSampler(counts, 0).epoch(32, 4)):
        for name, shards in (("default", sd), ("pair", sp), ("cost", sc)):
            got = cov_of_device_loads(device_loads(counts, shards))
            assert got == jsampler.cov_of_device_loads(
                jsampler.device_loads(counts, shards))
            cov[name].append(got)
    assert np.mean(cov["pair"]) < 0.5 * np.mean(cov["default"])
    assert np.mean(cov["pair"]) < 0.12
    assert np.mean(cov["cost"]) <= np.mean(cov["pair"])
    assert cov_of_device_loads(np.zeros(4)) == 0.0


# ---------------------------------------------------------------------------
# iterators, bit for bit against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", [False, True])
def test_batch_iterator_cost_mode_equals_jax(datasets, caps, tag):
    jds, ds = datasets
    want = list(JIter(jds, 8, 1, j_ladder(jds, 8), load_balance="cost",
                      seed=4, tag_indices=tag))
    got = list(BatchIterator(ds, 8, 1, caps, load_balance="cost", seed=4,
                             tag_indices=tag))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        if tag:
            assert isinstance(g, TaggedBatch)
            np.testing.assert_array_equal(g.indices, w.indices)
            g, w = g.batch, w.batch
        assert float(g.crystal_mask.sum()) == 8.0
        assert bool(torch.isfinite(g.energy).all())
        _assert_batches_equal(w, g)


@pytest.mark.parametrize("seed,micro,ladder", [
    (0, 2, True), (1, 2, False), (2, 3, True), (3, 1, True)])
def test_balanced_iterator_plans_equal_jax(datasets, seed, micro, ladder):
    """Plans field for field, bit for bit, seed for seed, with a refit cost
    model swapped in mid-epoch and a quarantine between epochs."""
    jds, ds = datasets
    jcaps = j_ladder(jds, 8) if ladder else j_caps(jds, 8)
    tcaps = ladder_for(ds, 8) if ladder else capacity_for(ds, 8)
    jit = JBalanced(jds, 8, 1, jcaps, num_micro=micro, seed=seed)
    tit = BalancedBatchIterator(ds, 8, 1, tcaps, num_micro=micro, seed=seed)
    assert tit.crystal_slots == jit.crystal_slots
    refit = dict(c0=1e-3, atoms=2e-5, bonds=3e-6, angles=1e-6)
    for epoch in range(2):
        n = 0
        for jp, tp in zip(jit, tit):
            _assert_plans_equal(jp, tp)
            n += 1
            if n == 2 and epoch == 0:
                jit.update_cost_model(jcost.CostModel(**refit))
                tit.update_cost_model(CostModel(**refit))
        assert n == 6 if epoch == 0 else n >= 5
        quarantined = np.arange(seed, 48, 7)
        jit.add_quarantine(quarantined)
        tit.add_quarantine(quarantined)
    plan = tit.plan_step(np.arange(40, 48))
    _assert_plans_equal(jit.plan_step(np.arange(40, 48)), plan)
    assert len(plan.micro) == min(micro, 8)
    assert plan.num_real == 8 and plan.micro_sizes.shape == (len(plan.micro),
                                                             3)


def test_more_devices_raise_naming_item_13(ds, caps):
    """More devices, which waited for ROADMAP item 13, shard now: each
    iterator yields one batch a device at one bucket (a plan one column a
    device, with one set of global denominators); what JAX refuses still
    raises."""
    for make in (lambda: BatchIterator(ds, 8, 2, caps),
                 lambda: BatchIterator(ds, 8, 2, caps, load_balance="cost")):
        shards = next(iter(make()))
        assert len(shards) == 2
        assert shards[0].atom_cap == shards[1].atom_cap
        assert shards[0].num_crystals == shards[1].num_crystals
    plan = next(iter(BalancedBatchIterator(ds, 8, 2, caps, num_micro=2)))
    assert plan.shard_costs.shape == (len(plan.micro), 2)
    assert all(len(m) == 2 for m in plan.micro) and plan.num_real == 8
    for make in (lambda: BatchIterator(ds, 8, 0, caps),
                 lambda: BatchIterator(ds, 1, 2, caps),
                 lambda: BalancedBatchIterator(ds, 8, 2, caps, shard=2)):
        with pytest.raises(ValueError):
            make()


# ---------------------------------------------------------------------------
# accumulation
# ---------------------------------------------------------------------------

def _trainer(cfg, tcfg, jparams):
    tr = Trainer(cfg, tcfg, device="cpu")
    tr.params = ttrain.params_on(
        params_from_numpy(jax.tree.map(np.asarray, jparams)), "cpu")
    tr.opt_state = adam_init(tr.params)
    return tr


def test_step_plan_matches_jax(datasets):
    """Two StepPlan steps (two microbatches each, in different buckets):
    the metrics and every updated parameter against JAX's
    ``Trainer._step_plan`` within TOL."""
    jds, ds = datasets
    jtcfg = jtrain.TrainConfig(global_batch=8, total_steps=100,
                               loss=JC.LOSS)
    tcfg = TrainConfig(global_batch=8, total_steps=100, loss=TC.LOSS)
    jtr = jtrain.Trainer(JC.FAST_FS_HEAD.with_(**SMALL), jtcfg, seed=0)
    tr = _trainer(CFG, tcfg, jtr.params)
    # a ladder sized for the microbatches: each takes its own bucket
    jit = JBalanced(jds, 8, 1, j_ladder(jds, 4), num_micro=2, seed=1)
    tit = BalancedBatchIterator(ds, 8, 1, ladder_for(ds, 4), num_micro=2,
                                seed=1)
    jplans, tplans = list(jit)[:2], list(tit)[:2]
    assert all(len({m.atom_cap for m in p.micro}) == 2 for p in tplans)
    want = jtr.train(jplans)
    got = tr.train(tplans)
    assert tr.step == jtr.step == 2
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)
    for path, a, b in zip(
            [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jtr.params)[0]],
            leaves(tr.params), jax.tree.leaves(jtr.params)):
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=path,
                                   **TOL)


def test_accum_matches_single_big_batch_f32(ds, caps):
    """tests/test_balance.py's bar: two microbatches in their own buckets
    give the one-microbatch update of the same indices within 1e-6."""
    tcfg = TrainConfig(global_batch=8, total_steps=100)
    idx = np.arange(8)
    plan_one = BalancedBatchIterator(ds, 8, 1, caps,
                                     num_micro=1).plan_step(idx)
    plan_two = BalancedBatchIterator(ds, 8, 1, caps,
                                     num_micro=2).plan_step(idx)
    assert len(plan_one.micro) == 1 and len(plan_two.micro) == 2
    tr_a = Trainer(CFG, tcfg, seed=0, device="cpu")
    tr_b = Trainer(CFG, tcfg, seed=0, device="cpu")
    h_a = tr_a.train([plan_one])
    h_b = tr_b.train([plan_two])
    assert abs(h_a[0]["loss"] - h_b[0]["loss"]) <= 1e-6
    diff = max(float((a - b).abs().max()) for a, b in
               zip(leaves(tr_a.params), leaves(tr_b.params)))
    assert diff <= 1e-6, diff
    # and the plan of one microbatch is the plain step on the same batch
    tr_c = Trainer(CFG, tcfg, seed=0, device="cpu")
    h_c = tr_c.train(plan_one.micro)
    assert abs(h_a[0]["loss"] - h_c[0]["loss"]) <= 1e-6


def test_accum_sums_microbatch_grads_in_order(ds, caps):
    """The summed gradients are the microbatches' gradients added in
    microbatch order, bit for bit."""
    tcfg = TrainConfig(global_batch=8)
    plan = BalancedBatchIterator(ds, 8, 1, caps, num_micro=3).plan_step(
        np.arange(8, 16))
    grad_step, _ = ttrain.make_chgnet_accum_step_fns(CFG, tcfg)
    tr = Trainer(CFG, tcfg, seed=2, device="cpu")
    parts = [grad_step(tr.params, m, plan.denoms)[0] for m in plan.micro]
    want = [(a + b) + c for a, b, c in zip(*parts)]
    seen = {}

    def apply_step(params, opt_state, grads, sums, denoms, step):
        seen["grads"] = [g.clone() for g in grads]
        seen["loss"] = sums["loss"]
        return params, opt_state, {"loss": sums["loss"]}

    tr._apply_step = apply_step
    tr.train([plan])
    for g, w in zip(seen["grads"], want):
        assert torch.equal(g, w)
    losses = [grad_step(tr.params, m, plan.denoms)[1]["loss"]
              for m in plan.micro]
    assert torch.equal(seen["loss"], (losses[0] + losses[1]) + losses[2])


def test_accum_mixed_precision_skips_on_inf_micro(ds, caps):
    """An inf in ONE microbatch poisons the summed gradients, so the one
    finite check skips the whole step and backs the loss scale off."""
    cfg = TC.FAST_FUSED_MIXED.with_(**SMALL)
    tcfg = TrainConfig(global_batch=8, total_steps=100)
    it = BalancedBatchIterator(ds, 8, 1, caps, num_micro=2)
    plan = it.plan_step(np.arange(8))
    bad = dataclasses.replace(
        plan.micro[1], energy=torch.full_like(plan.micro[1].energy,
                                              float("inf")))
    poisoned = StepPlan(micro=[plan.micro[0], bad], denoms=plan.denoms,
                        shard_costs=plan.shard_costs,
                        num_real=plan.num_real)
    tr = Trainer(cfg, tcfg, seed=0, device="cpu")
    scale0 = float(tr.opt_state["loss_scale"]["scale"])
    before = [p.detach().clone() for p in leaves(tr.params)]
    moments = [m.clone() for m in leaves(tr.opt_state["mu"])]
    hist = tr.train([poisoned])
    assert hist[0]["grads_finite"] == 0.0
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(tr.params)))
    assert all(torch.equal(a, b) for a, b in
               zip(moments, leaves(tr.opt_state["mu"])))
    assert int(tr.opt_state["count"]) == 0
    assert float(tr.opt_state["loss_scale"]["scale"]) == scale0 / 2
    hist2 = tr.train([it.plan_step(np.arange(8, 16))])
    assert hist2[0]["grads_finite"] == 1.0
    assert int(tr.opt_state["count"]) == 1


def test_cost_refit_reaches_the_iterator(ds, caps):
    """cost_refit_every: the Trainer times each microbatch past the
    warm-up, refits every K steps and hands the model to on_cost_model,
    which the iterator's next plans pack with."""
    tcfg = TrainConfig(global_batch=8, total_steps=100, cost_refit_every=2,
                       cost_refit_warmup=1, cost_refit_window=5)
    it = BalancedBatchIterator(ds, 8, 1, caps, num_micro=2, seed=3)
    tr = Trainer(CFG, tcfg, seed=0, device="cpu")
    tr.on_cost_model = it.update_cost_model
    hist = tr.train(it, max_steps=4)
    assert len(hist) == 4
    assert len(tr._cost_samples) == 5  # 3 plans x 2 micros, window 5
    assert isinstance(tr.cost_model, CostModel)
    assert it.cost_model is tr.cost_model
    np.testing.assert_array_equal(it.costs,
                                  tr.cost_model.predict_dataset(ds))
    for sizes, seconds in tr._cost_samples:
        assert sizes.shape == (3,) and seconds > 0


def test_trainer_rejects_other_items():
    tr = Trainer(CFG, TrainConfig(), device="cpu")
    with pytest.raises(TypeError, match="StepPlan"):
        tr.train([("indices", "plan")])


# ---------------------------------------------------------------------------
# the Prefetcher on plans and tagged batches
# ---------------------------------------------------------------------------

def test_prefetcher_moves_plans_and_tagged_batches(ds, caps):
    """Every microbatch of a StepPlan and a TaggedBatch's batch move (to
    the CPU device here), the indices stay numpy; training through the
    Prefetcher takes the steps it takes directly, bit for bit."""
    it = BalancedBatchIterator(ds, 8, 1, caps, num_micro=2, seed=6)
    want = list(it)[:3]
    tagged = [TaggedBatch(np.arange(i, i + 8), p) for i, p in
              enumerate(want)]
    got = list(Prefetcher(iter(tagged), depth=2, device="cpu"))
    assert len(got) == 3
    for g, w in zip(got, tagged):
        assert isinstance(g, TaggedBatch) and isinstance(g.batch, StepPlan)
        np.testing.assert_array_equal(g.indices, w.indices)
        for gm, wm in zip(g.batch.micro, w.batch.micro):
            assert isinstance(gm, CrystalGraphBatch)
            for k in FIELDS:
                assert torch.equal(getattr(gm, k), getattr(wm, k)), k
    with pytest.raises(TypeError, match="StepPlan"):
        list(Prefetcher(iter([("a", "b")]), device="cpu"))
    tcfg = TrainConfig(global_batch=8, total_steps=100)
    direct = Trainer(CFG, tcfg, seed=1, device="cpu").train(want)
    fed = Trainer(CFG, tcfg, seed=1, device="cpu").train(
        Prefetcher(iter(want), depth=2, device="cpu"))
    assert [h["loss"] for h in fed] == [h["loss"] for h in direct]
