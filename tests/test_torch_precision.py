"""The port's precision policy (DESIGN.md §4) against the JAX package on
the CPU, mirroring tests/test_precision.py at its §4 bounds (forward within
3e-2 absolute, gradients within 5% relative global norm and cosine >=
0.999) on the same 3-crystal batch, narrowed to dim 16 and 2 blocks.

Covers: policy resolution; the port at ``precision="mixed"`` against JAX
at ``"mixed"`` (forward and every gradient) and against the port at f32,
at the tiers of test_precision.py's matrix whose kernels have a bf16 path
(and FAST_FUSED_HALF_MIXED); the tiers whose kernels do not yet raise
when the model is built; the features reaching the convs and the force
readout are bf16; the bf16 operands of kernels 2, 3 and 4a against the
JAX wrappers (forward within one bf16 rounding, backward against the
custom VJPs); the dynamic loss scaler; a step on non-finite gradients
skips the whole update; bf16 parameters keep f32 master weights; the loss
descends under ``"mixed"``; the serve engine's ``precision=`` override;
bf16 parameter trees through ``convert``.  The port runs its plain
versions here, JAX its Pallas kernels in interpret mode.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.batching import BatchCapacities as JCaps  # noqa: E402
from repro.batching import batch_crystals as j_pack  # noqa: E402
from repro.core import neighbors as jn  # noqa: E402
from repro.core.chgnet import CHGNetConfig as JConfig  # noqa: E402
from repro.core.chgnet import chgnet_apply as j_apply  # noqa: E402
from repro.core.chgnet import chgnet_init as j_init  # noqa: E402
from repro.core.losses import LossWeights as JWeights  # noqa: E402
from repro.core.losses import chgnet_loss as j_loss  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import precision  # noqa: E402
from repro_torch.batching import BatchCapacities as TCaps  # noqa: E402
from repro_torch.batching import batch_crystals as t_pack  # noqa: E402
from repro_torch.batching import capacity_for  # noqa: E402
from repro_torch.configs import chgnet_mptrj as TC  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import CHGNet, chgnet as tchgnet  # noqa: E402
from repro_torch.core import interaction  # noqa: E402
from repro_torch.core import neighbors as tn  # noqa: E402
from repro_torch.core.chgnet import CHGNetConfig, chgnet_apply  # noqa: E402
from repro_torch.core.chgnet import chgnet_init  # noqa: E402
from repro_torch.core.losses import LossWeights, chgnet_loss  # noqa: E402
from repro_torch.data import BatchIterator, SyntheticConfig, make_dataset  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import trainer as ttrain  # noqa: E402

# DESIGN.md §4's bounds, as tests/test_precision.py states them
FWD_ATOL = 3e-2
GRAD_REL = 5e-2
GRAD_COS = 0.999
# one bf16 rounding of an output, relative to max(1, max|want|)
BF16_TOL = 2.0 ** -7
SMALL = dict(dim=16, num_blocks=2, num_rbf=7, num_fourier=7,
             readout="direct")
BF16 = torch.bfloat16


def _crystal(mod, rng, n):
    return mod.Crystal(
        lattice=np.eye(3) * 4.4 + rng.normal(0, .05, (3, 3)),
        frac_coords=rng.random((n, 3)),
        atomic_numbers=rng.integers(1, 60, n),
        energy=float(rng.normal()),
        forces=rng.normal(0, .1, (n, 3)),
        stress=rng.normal(0, .1, (3, 3)),
        magmoms=np.abs(rng.normal(0, 1, n)),
    )


def _batch(mod, pack, caps_cls):
    """tests/test_precision.py's batch: crystals of 5, 7 and 4 atoms."""
    rng = np.random.default_rng(0)
    cs = [_crystal(mod, rng, n) for n in (5, 7, 4)]
    gs = [mod.build_graph(c) for c in cs]
    return pack(cs, gs, caps_cls(24, sum(g.num_bonds for g in gs) + 16,
                                 sum(g.num_angles for g in gs) + 16))


@pytest.fixture(scope="module")
def batches():
    return _batch(jn, j_pack, JCaps), _batch(tn, t_pack, TCaps)


@pytest.fixture(scope="module")
def params():
    jp = j_init(jax.random.PRNGKey(0), JConfig(**SMALL), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _grad_gap(got, want):
    """Relative global-norm difference and cosine of two gradient lists."""
    got = [np.asarray(g, np.float64) for g in got]
    want = [np.asarray(w, np.float64) for w in want]
    norm = np.sqrt(sum((w ** 2).sum() for w in want))
    diff = np.sqrt(sum(((g - w) ** 2).sum() for g, w in zip(got, want)))
    cos = sum((g * w).sum() for g, w in zip(got, want)) / (
        norm * np.sqrt(sum((g ** 2).sum() for g in got)))
    return diff / norm, cos


def _assert_grads_close(got, want):
    rel, cos = _grad_gap(got, want)
    assert rel < GRAD_REL, rel
    assert cos > GRAD_COS, cos


# ---------------------------------------------------------------------------
# policy resolution
# ---------------------------------------------------------------------------

def test_policy_resolution():
    assert precision.resolve_policy("mixed") is precision.MIXED
    assert precision.resolve_policy(precision.BF16) is precision.BF16
    mixed = precision.MIXED
    assert mixed.param == torch.float32 and mixed.compute == BF16
    assert mixed.accum == torch.float32 and mixed.output == torch.float32
    assert not mixed.needs_master_weights
    assert precision.BF16.needs_master_weights
    assert precision.BF16.param == BF16 and not precision.F32.low_precision_compute
    with pytest.raises(ValueError):
        precision.resolve_policy("fp8")
    auto = precision.LossScaleConfig()
    assert auto.resolved_kind("f32") == "none"
    assert auto.resolved_kind("mixed") == "dynamic"
    assert precision.LossScaleConfig(kind="static").resolved_kind("f32") \
        == "static"
    # the trainer's name for it is the policy module's class
    assert ttrain.LossScaleConfig is precision.LossScaleConfig
    # a tree cast makes new tensors, even where the dtype already matches
    tree = {"w": torch.ones(2), "i": torch.zeros(2, dtype=torch.int32)}
    cast = precision.cast_float_tree(tree, torch.float32)
    assert cast["w"].data_ptr() != tree["w"].data_ptr()
    assert cast["i"] is tree["i"]


# ---------------------------------------------------------------------------
# the model at "mixed": against JAX, against the port's f32
# ---------------------------------------------------------------------------

# (mlp_impl, agg_impl, conv_impl, bond_store): the corners of
# tests/test_precision.py's TIERS whose kernels have a bf16 path, and
# FAST_FUSED_HALF_MIXED's (the undirected store's mirror operands)
TIERS = [
    ("packed", "scatter", "unfused", "directed"),
    ("ref", "sorted", "unfused", "directed"),
    ("packed", "matmul", "unfused", "directed"),
    ("packed", "scatter", "fused", "directed"),
    ("packed", "pallas", "fused", "directed"),
    ("packed", "pallas", "fused", "undirected"),
]


def _tier(mod_cfg, tier, prec):
    mlp, agg, conv, store = tier
    return mod_cfg(**SMALL, mlp_impl=mlp, agg_impl=agg, conv_impl=conv,
                   bond_store=store, precision=prec)


def _port_run(tp, cfg, batch):
    """The port's outputs and the loss's gradient leaves."""
    p = ttrain.params_on(tp, "cpu")
    out = chgnet_apply(p, cfg, batch)
    loss, _ = chgnet_loss(out, batch, LossWeights())
    grads = ttrain.grads_of(loss, p)
    return {k: v.detach() for k, v in out.items()}, grads


@pytest.mark.parametrize("tier", TIERS, ids=["-".join(t) for t in TIERS])
def test_mixed_matches_jax(batches, params, tier):
    """Forward and every gradient leaf at precision="mixed", the port
    against the JAX package at "mixed", within the §4 bounds; outputs are
    f32 (the output dtype) and the gradients f32 (the parameters')."""
    jb, tb = batches
    jp, tp = params
    jcfg = _tier(JConfig, tier, "mixed")

    def loss(p):
        out = j_apply(p, jcfg, jb)
        return j_loss(out, jb, JWeights())[0], out

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(jp)
    got, grads = _port_run(tp, _tier(CHGNetConfig, tier, "mixed"), tb)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=FWD_ATOL, err_msg=k)
    assert all(g.dtype == torch.float32 for g in grads)
    _assert_grads_close([g.numpy() for g in grads], jax.tree.leaves(jgrads))


@pytest.mark.parametrize("tier", TIERS, ids=["-".join(t) for t in TIERS])
def test_mixed_matches_f32(batches, params, tier):
    """The port at "mixed" against the port at f32 on one parameter tree,
    within the §4 bounds (test_precision.py's check on the port alone)."""
    _, tb = batches
    _, tp = params
    got, g_mx = _port_run(tp, _tier(CHGNetConfig, tier, "mixed"), tb)
    want, g_32 = _port_run(tp, _tier(CHGNetConfig, tier, "f32"), tb)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=FWD_ATOL, err_msg=k)
    _assert_grads_close([g.numpy() for g in g_mx], [g.numpy() for g in g_32])


@pytest.mark.parametrize("cfg", [
    TC.FAST_FS_HEAD.with_(mlp_impl="pallas", agg_impl="pallas"),
    TC.FAST_FUSED_SYM, TC.FAST_FUSED_VIRIAL,
], ids=["pallas-pallas-unfused", "FAST_FUSED_SYM", "FAST_FUSED_VIRIAL"])
def test_tiers_without_bf16_kernels_raise(batches, cfg):
    """At "mixed" the tiers whose CUDA kernels take f32 only (1 and 7, 5
    and 6, 4b) raise naming the next slice, when the model is built and
    when it is applied: none gives a result silently."""
    _, tb = batches
    cfg = cfg.with_(**SMALL, precision="mixed")
    with pytest.raises(NotImplementedError, match="next slice"):
        CHGNet(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="next slice"):
        chgnet_apply(chgnet_init(0, cfg.with_(precision="f32")), cfg, tb)
    with pytest.raises(NotImplementedError, match="next slice"):
        ttrain.Trainer(cfg, ttrain.TrainConfig(), device="cpu")


@pytest.mark.parametrize("tier", TIERS, ids=["-".join(t) for t in TIERS])
def test_trunk_features_are_bf16(batches, params, tier, monkeypatch):
    """At "mixed" every conv receives bf16 features (v, e, a, e_a, e_b: a
    bf16 feature times an f32 mask would silently be f32) and, on the
    fused tiers, every float operand of kernels 2, 3 and 4a is bf16."""
    _, tb = batches
    _, tp = params
    seen = []

    def spy(fn, name, first, count=None):
        def wrapped(*args, **kw):
            floats = [a for a in args[first:first + count if count else None]
                      if torch.is_tensor(a) and a.is_floating_point()]
            seen.append((name, [a.dtype for a in floats]))
            return fn(*args, **kw)
        return wrapped

    atom = spy(interaction.atom_conv, "atom_conv", 2, 3)  # v, e, e_a
    monkeypatch.setattr(interaction, "atom_conv", atom)
    monkeypatch.setattr(tchgnet, "atom_conv", atom)  # the final atom conv
    monkeypatch.setattr(interaction, "bond_conv",  # v, e, a, e_b
                        spy(interaction.bond_conv, "bond_conv", 2, 4))
    for name in ("fused_atom_conv", "fused_bond_conv", "fused_force_readout"):
        monkeypatch.setattr(tops, name, spy(getattr(tops, name), name, 0))
    with torch.no_grad():
        out = chgnet_apply(tp, _tier(CHGNetConfig, tier, "mixed"), tb)
    calls = {}
    for name, dtypes in seen:
        calls[name] = calls.get(name, 0) + 1
        assert dtypes and all(d == BF16 for d in dtypes), (name, dtypes)
    blocks = SMALL["num_blocks"]
    want = {"atom_conv": blocks + 1, "bond_conv": blocks}
    if tier[2] == "fused":
        want.update(fused_atom_conv=blocks + 1, fused_bond_conv=blocks,
                    fused_force_readout=1)
    assert calls == want
    assert all(v.dtype == torch.float32 for v in out.values())


# ---------------------------------------------------------------------------
# op level: kernels 2, 3 and 4a on bf16 operands
# ---------------------------------------------------------------------------

def _sorted_edges(rng, num_edges, num_segments, n_real):
    ids = np.sort(rng.integers(0, num_segments, n_real)).astype(np.int32)
    seg = np.zeros(num_edges, np.int32)
    seg[:n_real] = ids
    offs = np.searchsorted(ids, np.arange(num_segments + 1)).astype(np.int32)
    return seg, offs


def _f(rng, *shape, scale=1.0):
    return rng.normal(0, scale, shape).astype(np.float32)


def _mlp(rng, d_in, d):
    return (_f(rng, d_in, 2 * d, scale=d_in ** -0.5), _f(rng, 2 * d, scale=.1),
            rng.uniform(.5, 1.5, 2 * d).astype(np.float32),
            _f(rng, 2 * d, scale=.1))


def _op_case(kind):
    """(JAX wrapper, port wrapper, float operands, the other arguments,
    keyword arguments) of one kernel on a padded tail."""
    rng = np.random.default_rng(11)
    d, a_rows, eu = 16, 12, 70
    if kind.startswith("atom"):
        e_rows, n_real = 160, 140
        seg, offs = _sorted_edges(rng, e_rows, a_rows, n_real)
        pair = rng.integers(0, eu, e_rows).astype(np.int32)
        und = kind == "atom[pair+und]"
        mirror = kind != "atom"
        floats = [_f(rng, a_rows, d), _f(rng, eu if und else e_rows, d),
                  _f(rng, eu if mirror else e_rows, d)] + list(_mlp(rng, 3 * d, d))
        ints = [seg, rng.integers(0, a_rows, e_rows).astype(np.int32), offs]
        kw = dict(pair=pair, und_features=und) if mirror else {}
        return "fused_atom_conv", floats, ints, kw
    if kind.startswith("bond"):
        b_rows, n_ang, n_real = 40, 150, 120
        seg, offs = _sorted_edges(rng, n_ang, b_rows, n_real)
        mirror = kind == "bond[pair]"
        floats = [_f(rng, a_rows, d), _f(rng, b_rows, d), _f(rng, n_ang, d),
                  _f(rng, eu if mirror else b_rows, d)] \
            + list(_mlp(rng, 4 * d, d))
        ints = [seg, rng.integers(0, b_rows, n_ang).astype(np.int32),
                rng.integers(0, a_rows, n_ang).astype(np.int32), offs]
        kw = dict(pair=rng.integers(0, eu, b_rows).astype(np.int32)) \
            if mirror else {}
        return "fused_bond_conv", floats, ints, kw
    e_rows, n_real = 160, 140
    seg, offs = _sorted_edges(rng, e_rows, a_rows, n_real)
    xh = _f(rng, e_rows, 3)
    xh /= np.linalg.norm(xh, axis=1, keepdims=True)
    floats = [_f(rng, e_rows, d), xh, _f(rng, d, d, scale=d ** -0.5),
              _f(rng, d, scale=.1), _f(rng, d, 1, scale=d ** -0.5),
              _f(rng, 1, scale=.1)]
    return "fused_force_readout", floats, [seg, offs, a_rows], {}


OP_CASES = ["atom", "atom[pair]", "atom[pair+und]", "bond", "bond[pair]",
            "force"]


def _j(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _t(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("kind", OP_CASES)
def test_bf16_kernel_operands_match_jax(kind):
    """Kernels 2 (directed, pair, pair + und), 3 (directed, pair) and 4a
    on bf16 operands: the port's wrapper (its plain version here: f32
    inside, rounded once) against the JAX wrapper (the Pallas kernel in
    interpret mode) on the same bf16 inputs, within one bf16 rounding of
    the output; the backward (the recompute in f32, cotangents cast to the
    operands' bf16) against JAX's custom VJP at the §4 gradient bound."""
    name, floats, ints, kw = _op_case(kind)
    jf = [jnp.asarray(x, jnp.bfloat16) for x in floats]
    tf = [torch.from_numpy(x).to(BF16).requires_grad_() for x in floats]
    jkw = {k: _j(v) for k, v in kw.items()}
    tkw = {k: _t(v) for k, v in kw.items()}

    def jfn(*xs):
        return getattr(jops, name)(*xs, *map(_j, ints), **jkw)

    want, vjp = jax.vjp(jfn, *jf)
    got = getattr(tops, name)(*tf, *map(_t, ints), **tkw)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    want32 = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want32).max()
    assert err <= BF16_TOL * max(1.0, np.abs(want32).max()), err
    r = np.random.default_rng(5).normal(0, 1, want.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(r, jnp.bfloat16))
    tgrads = torch.autograd.grad(
        (got.float() * torch.from_numpy(r).to(BF16).float()).sum(), tf)
    assert all(g.dtype == BF16 for g in tgrads)
    _assert_grads_close([g.float().numpy() for g in tgrads],
                        [np.asarray(g, np.float32) for g in jgrads])


@pytest.mark.parametrize("kind", ["atom", "bond", "force"])
def test_cuda_wrappers_refuse_mixed_operand_dtypes(kind):
    """A bf16 call whose float operands do not share one dtype fails on
    the card's checks; the f32-only kernels keep refusing bf16."""
    name, floats, ints, kw = _op_case(kind)
    tf = [torch.from_numpy(x).to(BF16) for x in floats]
    tf[-1] = tf[-1].float()
    cuda = {"fused_atom_conv": tops._atom_conv_cuda,
            "fused_bond_conv": tops._bond_conv_cuda,
            "fused_force_readout": tops._force_readout_cuda}[name]
    args = tf + [_t(x) for x in ints]
    if name == "fused_atom_conv":
        args += [_t(kw.get("pair")), False]
    elif name == "fused_bond_conv":
        seg, ik = args[8], args[9]
        args += [seg, ik, False]
    with pytest.raises(TypeError, match="dtype"):
        cuda(*args)
    seg = torch.zeros(8, dtype=torch.int32)
    offs = torch.tensor([0, 4, 8], dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        tops._force_virial_cuda(
            torch.zeros(8, 16, dtype=BF16), torch.zeros(8, 3, dtype=BF16),
            torch.ones(8, dtype=BF16), torch.zeros(16, 16, dtype=BF16),
            torch.zeros(16, dtype=BF16), torch.zeros(16, 1, dtype=BF16),
            torch.zeros(1, dtype=BF16), seg, seg, offs, 2, 1)


# ---------------------------------------------------------------------------
# loss scaler and the train step
# ---------------------------------------------------------------------------

def test_dynamic_scaler_halves_and_grows():
    cfg = precision.LossScaleConfig(kind="dynamic", init_scale=1024.0,
                                    growth_interval=2, min_scale=1.0,
                                    max_scale=4096.0)
    update = precision.loss_scale_update
    s = precision.loss_scale_init(cfg)
    # non-finite grads: halve, reset the good-step counter
    s = update(s, False, cfg, "dynamic")
    assert float(s["scale"]) == 512.0 and int(s["good_steps"]) == 0
    # growth_interval consecutive finite steps: double, counter resets
    s = update(s, torch.tensor(True), cfg, "dynamic")
    assert float(s["scale"]) == 512.0 and int(s["good_steps"]) == 1
    s = update(s, True, cfg, "dynamic")
    assert float(s["scale"]) == 1024.0 and int(s["good_steps"]) == 0
    # clamps
    s = {"scale": torch.tensor(1.5), "good_steps": torch.tensor(0)}
    assert float(update(s, False, cfg, "dynamic")["scale"]) == 1.0
    s = {"scale": torch.tensor(4096.0), "good_steps": torch.tensor(1)}
    assert float(update(s, True, cfg, "dynamic")["scale"]) == 4096.0
    # static: the scale never moves
    st = precision.loss_scale_init(cfg)
    assert float(update(st, False, cfg, "static")["scale"]) == 1024.0
    loss = torch.tensor(2.0)
    assert float(precision.scale_loss(loss, st)) == 2048.0


MIXED_CFG = TC.FAST_FUSED_MIXED.with_(**SMALL)


def test_train_step_skips_update_on_nonfinite_grads(batches):
    """An inf label gives non-finite gradients: the step leaves the
    parameters, Adam's moments and its count as they were, reports
    grads_finite 0 and halves the scale; a clean batch then updates, and
    the scale grows after growth_interval finite steps."""
    _, tb = batches
    tcfg = ttrain.TrainConfig(
        global_batch=4, total_steps=10,
        loss_scale=precision.LossScaleConfig(kind="dynamic",
                                             init_scale=256.0,
                                             growth_interval=2))
    tr = ttrain.Trainer(MIXED_CFG, tcfg, device="cpu")
    assert "loss_scale" in tr.opt_state and "master" not in tr.opt_state
    energy = tb.energy.clone()
    energy[0] = float("inf")
    bad = dataclasses.replace(tb, energy=energy)
    p0 = [p.detach().clone() for p in leaves(tr.params)]
    p2, o2, m = tr._train_step(tr.params, tr.opt_state, bad, 0)
    assert float(m["grads_finite"]) == 0.0
    assert float(o2["loss_scale"]["scale"]) == 128.0
    assert int(o2["count"]) == 0
    for a, b in zip(leaves(p2), p0):
        assert torch.equal(a, b)
    assert not any(t.any() for t in leaves(o2["mu"]) + leaves(o2["nu"]))
    # the Trainer takes a skipped step in its stride (no FloatingPointError)
    tr.params, tr.opt_state = p2, o2
    hist = tr.train([bad])
    assert hist[0]["grads_finite"] == 0.0 and tr.step == 1
    assert float(tr.opt_state["loss_scale"]["scale"]) == 64.0
    p3, o3, m3 = tr._train_step(tr.params, tr.opt_state, tb, 0)
    assert float(m3["grads_finite"]) == 1.0 and int(o3["count"]) == 1
    assert any(not torch.equal(a, b) for a, b in zip(leaves(p3), p0))
    _, o4, m4 = tr._train_step(p3, o3, tb, 1)
    assert float(o4["loss_scale"]["scale"]) == 128.0  # 64 * 2
    assert float(m4["loss_scale"]) == 128.0 and int(o4["count"]) == 2


def test_bf16_policy_keeps_f32_master_weights(batches):
    """precision="bf16": parameters stored bf16 (rbf_freqs f32, they feed
    the f32 basis), an f32 master copy in Adam; after a step the live
    parameters are the bf16 cast of the stepped master."""
    _, tb = batches
    tr = ttrain.Trainer(TC.FAST_FUSED.with_(**SMALL, precision="bf16"),
                        ttrain.TrainConfig(global_batch=4, total_steps=10),
                        device="cpu")
    assert "master" in tr.opt_state
    assert tr.params["rbf_freqs"].dtype == torch.float32
    rest = dict(tr.params)
    rest.pop("rbf_freqs")
    assert all(p.dtype == BF16 for p in leaves(rest))
    assert all(m.dtype == torch.float32
               for m in leaves(tr.opt_state["master"]))
    assert all(m.dtype == torch.float32 for m in leaves(tr.opt_state["mu"]))
    p2, o2, m = tr._train_step(tr.params, tr.opt_state, tb, 0)
    assert float(m["grads_finite"]) == 1.0 and int(o2["count"]) == 1
    for live, master in zip(leaves(p2), leaves(o2["master"])):
        assert torch.equal(live, master.to(live.dtype))


def test_mixed_training_loss_descends():
    """tests/test_precision.py's smoke on the port at FAST_FUSED_MIXED
    (narrowed): 40 steps bring a held-out batch's loss down, every step's
    gradients finite."""
    ds = make_dataset(SyntheticConfig(num_crystals=32, max_atoms=12, seed=0))
    caps = capacity_for(ds, 8)
    tcfg = ttrain.TrainConfig(global_batch=8, total_steps=300, lr_k=1,
                              warmup_steps=5)
    tr = ttrain.Trainer(MIXED_CFG, tcfg, device="cpu")
    held_out = next(iter(BatchIterator(ds, 8, 1, caps, seed=99)))
    before = tr.evaluate(held_out)["loss"]
    hist = tr.train(itertools.islice(
        itertools.cycle(iter(BatchIterator(ds, 8, 1, caps))), 40))
    after = tr.evaluate(held_out)["loss"]
    assert after < before, (before, after)
    assert all(h["grads_finite"] == 1.0 for h in hist)
    assert all(h["loss_scale"] == 2.0 ** 12 for h in hist)


# ---------------------------------------------------------------------------
# serving and the weight bridge
# ---------------------------------------------------------------------------

def test_serve_engine_precision_override(params):
    """ServeEngine(..., precision="mixed") serves f32 parameters at the
    mixed policy: f32 outputs within the §4 bound of the f32 engine."""
    _, tp = params
    rng = np.random.default_rng(4)
    cs = [_crystal(tn, rng, n) for n in (5, 6)]
    cfg = TC.FAST_FUSED.with_(**SMALL)
    engine = ServeEngine.for_structures(tp, cfg, cs, precision="mixed",
                                        device="cpu")
    assert engine.model_cfg.precision == "mixed"
    assert engine.model.cfg.precision == "mixed"
    out = engine.predict(cs)
    want = ServeEngine.for_structures(tp, cfg, cs, device="cpu").predict(cs)
    np.testing.assert_allclose(out["energy"], want["energy"], atol=FWD_ATOL)
    for f_got, f_want in zip(out["forces"], want["forces"]):
        assert f_got.dtype == np.float32
        np.testing.assert_allclose(f_got, f_want, atol=FWD_ATOL)


def test_bf16_parameter_trees_round_trip():
    """A JAX parameter tree at the bf16 policy (bf16 leaves, rbf_freqs f32)
    goes through convert into a CHGNet and back bit for bit; the port's
    own init stores the same dtypes."""
    cfg = dict(SMALL, precision="bf16")
    jp = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(2),
                                         JConfig(**cfg)))
    tp = params_from_numpy(jp)
    assert tp["rbf_freqs"].dtype == torch.float32
    assert tp["blocks"][0]["atom_mlp"]["w"].dtype == BF16
    model = CHGNet(CHGNetConfig(**cfg), tp, device="cpu")
    back = params_to_numpy(model)
    for want, got in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert got.dtype == want.dtype
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    own = chgnet_init(0, CHGNetConfig(**cfg))
    assert [t.dtype for t in leaves(own)] == \
        [torch.float32 if "float32" in str(w.dtype) else BF16
         for w in jax.tree.leaves(jp)]
