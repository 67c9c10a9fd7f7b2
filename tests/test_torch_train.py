"""The port's training slice against the JAX package on the CPU: the
synthetic labels and the BatchIterator's batches (bitwise), the losses,
the loss and every parameter gradient at FAST_FUSED and
FAST_FUSED_VIRIAL, Adam on fixed gradients, the clip, the schedule, and
a two-step Trainer run; every Trainer option of a later ROADMAP item
raises.  The port runs its kernels' path (the recompute backwards over
the plain versions); the JAX side runs the unfused twins FAST_FS_HEAD /
FAST_VIRIAL, which tests/test_fused_message_passing.py and
tests/test_virial.py hold equal to the fused tiers."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import chgnet_mptrj as JC  # noqa: E402
from repro.core import losses as jl  # noqa: E402
from repro.core.chgnet import chgnet_apply as j_apply  # noqa: E402
from repro.core.chgnet import chgnet_init as j_init  # noqa: E402
from repro.data import BatchIterator as JIter  # noqa: E402
from repro.data import SyntheticConfig as JSyn  # noqa: E402
from repro.data import capacity_for as j_caps  # noqa: E402
from repro.data import make_dataset as j_dataset  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.optim import grad as jgrad  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.train import trainer as jtrain  # noqa: E402
from repro_torch.batching import capacity_for as t_caps  # noqa: E402
from repro_torch.configs import chgnet_mptrj as TC  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import losses as tl  # noqa: E402
from repro_torch.core.graph import FIELDS  # noqa: E402
from repro_torch.data import BatchIterator, SyntheticConfig, make_dataset  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.optim import grad as tgrad  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.train import trainer as ttrain  # noqa: E402

SMALL = dict(dim=16, num_blocks=1, num_rbf=7, num_fourier=7)
TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_model.py's tolerance
SYN = dict(num_crystals=12, max_atoms=14, seed=3)


@pytest.fixture(scope="module")
def datasets():
    return j_dataset(JSyn(**SYN)), make_dataset(SyntheticConfig(**SYN))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def test_labels_are_bitwise_equal(datasets):
    jds, tds = datasets
    assert len(jds) == len(tds)
    for jc, tc, jg, tg in zip(jds.crystals, tds.crystals, jds.graphs,
                              tds.graphs):
        for k in ("lattice", "frac_coords", "atomic_numbers", "forces",
                  "stress", "magmoms"):
            np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k),
                                          err_msg=k)
        assert tc.energy == jc.energy
        for k in ("bond_center", "bond_nbr", "bond_image", "angle_ij",
                  "angle_ik"):
            np.testing.assert_array_equal(getattr(tg, k), getattr(jg, k))
    np.testing.assert_array_equal(tds.feature_counts(), jds.feature_counts())


@pytest.mark.parametrize("load_balance", [True, False])
def test_batch_iterator_is_bitwise_equal(datasets, load_balance):
    """Same seed, same batches: every one of the 35 fields."""
    jds, tds = datasets
    caps = t_caps(tds, 4)
    assert dataclasses.asdict(caps) == dataclasses.asdict(j_caps(jds, 4))
    jit = JIter(jds, 4, 1, j_caps(jds, 4), load_balance=load_balance,
                seed=5, drop_last=False)
    tit = BatchIterator(tds, 4, 1, caps, load_balance=load_balance, seed=5,
                        drop_last=False)
    n = 0
    for jb, tb in itertools.zip_longest(jit, tit):
        for k in FIELDS:
            want, got = np.asarray(getattr(jb, k)), getattr(tb, k).numpy()
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        n += 1
    assert n == 3


def _batches(datasets, batch=4):
    jds, tds = datasets
    jb = next(iter(JIter(jds, batch, 1, j_caps(jds, batch), seed=1)))
    tb = next(iter(BatchIterator(tds, batch, 1, t_caps(tds, batch),
                                 seed=1)))
    return jb, tb


def test_losses_match_jax(datasets):
    jb, tb = _batches(datasets)
    rng = np.random.default_rng(0)
    pred = {"energy": rng.normal(0, 3, tb.num_crystals),
            "forces": rng.normal(0, .3, (tb.atom_cap, 3)),
            "stress": rng.normal(0, .3, (tb.num_crystals, 3, 3)),
            "magmom": rng.normal(0, .3, tb.atom_cap)}
    pred = {k: v.astype(np.float32) for k, v in pred.items()}
    tpred = {k: torch.from_numpy(v) for k, v in pred.items()}
    jpred = {k: jnp.asarray(v) for k, v in pred.items()}
    w = TC.LOSS
    t_loss, t_m = tl.chgnet_loss(tpred, tb, w)
    j_loss, j_m = jl.chgnet_loss(jpred, jb, JC.LOSS)
    for k in j_m:
        np.testing.assert_allclose(_np(t_m[k]), np.asarray(j_m[k]),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(_np(t_loss), np.asarray(j_loss), rtol=1e-6)
    n_c = int(tb.crystal_mask.sum())
    n_a = int(tb.atom_mask.sum())
    t_d = tl.global_denominators(n_c, n_a)
    assert t_d == jl.global_denominators(n_c, n_a)
    t_sl, t_s = tl.chgnet_loss_sums(tpred, tb, w, t_d)
    j_sl, j_s = jl.chgnet_loss_sums(jpred, jb, JC.LOSS, t_d)
    np.testing.assert_allclose(_np(t_sl), np.asarray(j_sl), rtol=1e-6)
    np.testing.assert_allclose(_np(t_sl), _np(t_loss), rtol=1e-6)
    t_mm = tl.metrics_from_sums(t_s, t_d)
    j_mm = jl.metrics_from_sums(j_s, t_d)
    for k in j_mm:
        np.testing.assert_allclose(_np(t_mm[k]), np.asarray(j_mm[k]),
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(_np(t_mm[k]), _np(t_m[k]), rtol=1e-6)


def _config(mod, name):
    """A named config, or the unfused Pallas tier with the direct
    (FAST_PALLAS) or the autodiff readout (WO_HEAD_PALLAS): labels of the
    tests and chip_smoke.py only."""
    pallas = dict(mlp_impl="pallas", agg_impl="pallas")
    if name == "FAST_PALLAS":
        return mod.FAST_FS_HEAD.with_(**pallas)
    if name == "WO_HEAD_PALLAS":
        return mod.FAST_WO_HEAD.with_(**pallas)
    return getattr(mod, name)


@pytest.mark.parametrize("port,twin", [("FAST_FUSED", "FAST_FS_HEAD"),
                                       ("FAST_FUSED_VIRIAL", "FAST_VIRIAL"),
                                       ("FAST_PALLAS", "FAST_PALLAS"),
                                       ("REFERENCE", "REFERENCE"),
                                       ("WO_HEAD_PALLAS", "WO_HEAD_PALLAS")])
def test_loss_and_param_grads_match_jax(datasets, port, twin):
    """The loss and the gradient of every parameter leaf through the
    port's kernels' path against jax.grad of the same loss.  FAST_PALLAS
    runs the unfused tier's wrappers on both sides (the Pallas kernels in
    interpret mode on the JAX side); REFERENCE and WO_HEAD_PALLAS train
    through the autodiff readout, a second-order gradient, the latter
    through the wrappers' backwards twice."""
    jb, tb = _batches(datasets)
    jcfg = _config(JC, twin).with_(**SMALL)
    tcfg = _config(TC, port).with_(**SMALL)
    jp = j_init(jax.random.PRNGKey(4), jcfg)

    def j_loss(p):
        return jl.chgnet_loss(j_apply(p, jcfg, jb), jb, JC.LOSS)[0]

    want_loss, want = jax.jit(jax.value_and_grad(j_loss))(jp)
    tp = ttrain.params_on(params_from_numpy(jax.tree.map(np.asarray, jp)),
                          "cpu")
    loss, _ = ttrain.chgnet_loss_fn(tp, tcfg, tb, TC.LOSS)
    got = ttrain.grads_of(loss, tp)
    np.testing.assert_allclose(_np(loss), np.asarray(want_loss), **TOL)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    assert len(got) == len(paths)
    for path, g, w in zip(paths, got, jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=path,
                                   **TOL)


def _tree(rng, scale=1.0):
    return {"b": [{"w": rng.normal(0, scale, (3, 4)).astype(np.float32)},
                  {"w": rng.normal(0, scale, (2,)).astype(np.float32)}],
            "a": rng.normal(0, scale, (5,)).astype(np.float32)}


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(x.copy()), tree)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_on_fixed_grads_matches_jax(weight_decay):
    """Three Adam steps on the same fixed gradients: parameters and
    moments track JAX's adam_update."""
    rng = np.random.default_rng(7)
    cfg_j = jadam.AdamConfig(weight_decay=weight_decay)
    cfg_t = tadam.AdamConfig(weight_decay=weight_decay)
    p_np = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p_np), _to_torch(p_np)
    js, ts = jadam.adam_init(jp), tadam.adam_init(tp)
    for lr in (1e-2, 3e-3, 5e-4):
        g = _tree(rng, 0.1)
        jp, js = jadam.adam_update(jax.tree.map(jnp.asarray, g), js, jp, lr,
                                   cfg_j)
        tp, ts = tadam.adam_update(_to_torch(g), ts, tp, lr, cfg_t)
        for got, want in zip(leaves(tp) + leaves(ts["mu"]) + leaves(ts["nu"]),
                             jax.tree.leaves(jp) + jax.tree.leaves(js["mu"])
                             + jax.tree.leaves(js["nu"])):
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-5, atol=1e-8)
        assert int(ts["count"]) == int(js["count"])
    # bf16 parameters with f32 master weights (DESIGN.md §4): the master
    # copy and the moments track JAX's, the live parameters are its cast
    jb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    tb = jax.tree.map(lambda x: x.to(torch.bfloat16), tp)
    js = jadam.adam_init(jb, master_dtype=jnp.float32)
    ts = tadam.adam_init(tb, master_dtype=torch.float32)
    for lr in (1e-2, 3e-3):
        g = _tree(rng, 0.1)
        jb, js = jadam.adam_update(jax.tree.map(jnp.asarray, g), js, jb, lr,
                                   cfg_j)
        tb, ts = tadam.adam_update(_to_torch(g), ts, tb, lr, cfg_t)
        for got, want in zip(
                leaves(ts["master"]) + leaves(ts["mu"]) + leaves(ts["nu"]),
                jax.tree.leaves(js["master"]) + jax.tree.leaves(js["mu"])
                + jax.tree.leaves(js["nu"])):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-5, atol=1e-8)
        for live, master in zip(leaves(tb), leaves(ts["master"])):
            assert live.dtype == torch.bfloat16
            assert torch.equal(live, master.to(torch.bfloat16))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(1))
    jg = jax.tree.map(jnp.asarray, g)
    np.testing.assert_allclose(_np(tgrad.global_norm(_to_torch(g))),
                               np.asarray(jgrad.global_norm(jg)), rtol=1e-6)
    got = tgrad.clip_by_global_norm(_to_torch(g), max_norm)
    want = jgrad.clip_by_global_norm(jg, max_norm)
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)
    assert bool(tgrad.tree_all_finite(_to_torch(g)))
    g["a"][0] = np.nan
    assert not bool(tgrad.tree_all_finite(_to_torch(g)))


def test_schedule_matches_jax():
    assert tsched.scaled_init_lr(2048) == jsched.scaled_init_lr(2048)
    for step in (0, 2, 5, 6, 40, 99, 100, 150):
        for warm, floor in ((0, 0.0), (5, 0.1)):
            got = tsched.cosine_annealing(step, 100, 2.4e-3,
                                          warmup_steps=warm,
                                          min_lr_ratio=floor)
            want = jsched.cosine_annealing(step, 100, 2.4e-3,
                                           warmup_steps=warm,
                                           min_lr_ratio=floor)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-6, err_msg=f"{step} {warm}")


def test_train_config_mirrors_jax():
    assert [f.name for f in dataclasses.fields(ttrain.TrainConfig)] == \
        [f.name for f in dataclasses.fields(jtrain.TrainConfig)]
    assert dataclasses.asdict(ttrain.TrainConfig()) == \
        dataclasses.asdict(jtrain.TrainConfig())
    assert ttrain.TrainConfig(global_batch=8, lr_k=1).init_lr == \
        jtrain.TrainConfig(global_batch=8, lr_k=1).init_lr


def test_two_trainer_steps_match_jax(datasets):
    """The same parameters and batches through two steps of each
    package's Trainer: the same losses."""
    jds, tds = datasets
    tcfg_j = jtrain.TrainConfig(global_batch=4, total_steps=10, lr_k=1,
                                loss=JC.LOSS)
    tcfg_t = ttrain.TrainConfig(global_batch=4, total_steps=10, lr_k=1,
                                loss=TC.LOSS)
    jtr = jtrain.Trainer(JC.FAST_FS_HEAD.with_(**SMALL), tcfg_j, seed=0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jtr.params))
    want = jtr.train(JIter(jds, 4, 1, j_caps(jds, 4), seed=2), max_steps=2)
    tr = ttrain.Trainer(TC.FAST_FUSED.with_(**SMALL), tcfg_t, device="cpu")
    tr.params = ttrain.params_on(tp, "cpu")
    tr.opt_state = tadam.adam_init(tr.params)
    got = tr.train(BatchIterator(tds, 4, 1, t_caps(tds, 4), seed=2),
                   max_steps=2)
    assert tr.step == 2 and len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)
        assert np.isfinite(g["grad_norm"])
    metrics = tr.evaluate(next(iter(BatchIterator(tds, 4, 1, t_caps(tds, 4),
                                                  seed=9))))
    assert set(metrics) == set(want[0]) and np.isfinite(metrics["loss"])
    out = tr.serve(next(iter(BatchIterator(tds, 4, 1, t_caps(tds, 4)))))
    assert out["forces"].requires_grad is False


CFG = TC.FAST_FUSED.with_(**SMALL)


@pytest.mark.parametrize("kwargs,train_cfg,item", [
    (dict(mesh=object()), {}, "item 13"),
    (dict(ckpt_dir="ckpt"), {}, "item 12"),
    (dict(async_ckpt=True), {}, "item 12"),
    (dict(shutdown=object()), {}, "item 12"),
    ({}, dict(rollback_on_divergence=True), "item 10"),
    ({}, dict(cost_refit_every=4), "item 10"),
])
def test_unported_trainer_options_raise(kwargs, train_cfg, item):
    with pytest.raises(NotImplementedError, match=item):
        ttrain.Trainer(CFG, ttrain.TrainConfig(**train_cfg), device="cpu",
                       **kwargs)


def test_unported_training_paths_raise(datasets):
    _, tds = datasets
    caps = t_caps(tds, 4)
    tr = ttrain.Trainer(CFG, ttrain.TrainConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        tr.train([], fault_injector=object())
    with pytest.raises(NotImplementedError, match="item 10"):
        tr.train([("indices", "plan")])
    with pytest.raises(NotImplementedError, match="item 9"):
        BatchIterator(tds, 4, 2, caps)
    with pytest.raises(NotImplementedError, match="item 9"):
        BatchIterator(tds, 4, 1, caps, load_balance="cost")
    with pytest.raises(NotImplementedError, match="item 9"):
        pipeline.BalancedBatchIterator(tds, 4, 1, caps)


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.Trainer(CFG, ttrain.TrainConfig())
