"""Mirror of tests/test_bond_store.py on the port: the undirected bond
store's mirror maps (the construction, a ragged hypothesis sweep with
self-image bonds and both cap modes, the packer's invariant), undirected
== directed forward and every gradient leaf across the mlp x agg x conv
tiers and both readouts, equivariance, Verlet serving, and training
smokes at the Pallas tier.

Each test asserts on the port what its JAX namesake asserts on the JAX
package.  Where the JAX test computes a value, the port's maps equal the
JAX package's (bitwise), and the port's outputs and gradients are also
held to JAX's directed plain tier on the same batch and parameters
(the port's seeded ``chgnet_init`` as numpy arrays; the port's copy
through ``convert.params_from_numpy``) within ``1e-5 * max(1, max|jax|)``
(3e-2 at "mixed" and "bf16", DESIGN.md §4).  The JAX tests hold JAX's
own tiers to that plain tier.  Sizes: dim 16, one block."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.batching import BatchCapacities as JCaps  # noqa: E402
from repro.batching import batch_crystals as j_pack  # noqa: E402
from repro.core import neighbors as jn  # noqa: E402
from repro.core.chgnet import CHGNetConfig as JConfig  # noqa: E402
from repro.core.chgnet import chgnet_apply as j_apply  # noqa: E402
from repro.core.losses import LossWeights as JLoss  # noqa: E402
from repro.core.losses import chgnet_loss as j_loss  # noqa: E402
from repro_torch.batching import BatchCapacities, batch_crystals  # noqa: E402
from repro_torch.batching import validate_layout  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.chgnet import CHGNetConfig, chgnet_apply, chgnet_init  # noqa: E402
from repro_torch.core.losses import LossWeights, chgnet_loss  # noqa: E402
from repro_torch.core.neighbors import (  # noqa: E402
    Crystal, VerletNeighborList, build_graph,
)
from repro_torch.optim.adam import adam_init  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.serve import BatchedMD, ServeEngine  # noqa: E402
from repro_torch.train import TrainConfig, make_chgnet_step_fns  # noqa: E402
from repro_torch.train.trainer import params_on  # noqa: E402

SMALL = dict(dim=16, num_blocks=1, num_rbf=7, num_fourier=7)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, atol, msg):
    scale = max(1.0, float(np.max(np.abs(_np(want)))))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=atol * scale, err_msg=msg)


def _arrays(rng, n, labels=True, scale=4.0):
    kw = dict(lattice=np.eye(3) * scale + rng.normal(0, .05, (3, 3)),
              frac_coords=rng.random((n, 3)),
              atomic_numbers=rng.integers(1, 60, n))
    if labels:
        kw.update(energy=float(rng.normal()),
                  forces=rng.normal(0, .1, (n, 3)),
                  stress=rng.normal(0, .1, (3, 3)),
                  magmoms=np.abs(rng.normal(0, 1, n)))
    return kw


def _crystal(rng, n, labels=True, scale=4.0):
    return Crystal(**_arrays(rng, n, labels, scale))


def _batch(rng, sizes=(5, 7, 4), **kw):
    cs = [_crystal(rng, n, **kw) for n in sizes]
    gs = [build_graph(c) for c in cs]
    caps = BatchCapacities(sum(sizes) + 8,
                           sum(g.num_bonds for g in gs) + 16,
                           sum(g.num_angles for g in gs) + 16)
    return batch_crystals(cs, gs, caps)


def _init(seed, **kw):
    """One parameter tree for both packages: JAX's, and the port's copy
    (JAX's own init is slow eagerly on the CPU)."""
    src = jax.tree.map(lambda t: t.numpy(),
                       chgnet_init(seed, CHGNetConfig(**SMALL, **kw)))
    return jax.tree.map(jnp.asarray, src), params_from_numpy(src)


@pytest.fixture(scope="module")
def ref():
    """One batch in both packages, JAX's parameters in both, and JAX's
    directed plain tier's outputs and gradients, each computed once."""
    rng = np.random.default_rng(0)
    arrays = [_arrays(rng, n) for n in (5, 7, 4)]
    jc = [jn.Crystal(**a) for a in arrays]
    tc = [Crystal(**a) for a in arrays]
    jg = [jn.build_graph(c) for c in jc]
    caps = (sum(c.num_atoms for c in jc) + 8,
            sum(g.num_bonds for g in jg) + 16,
            sum(g.num_angles for g in jg) + 16)
    jb = j_pack(jc, jg, JCaps(*caps))
    tb = batch_crystals(tc, [build_graph(c) for c in tc],
                        BatchCapacities(*caps))
    jp, tp = _init(0)
    return dict(jb=jb, tb=tb, jp=jp, cache={}, tp=tp)


def _jax(ref, what, **kw):
    """JAX's outputs ("out") or gradient leaves ("grad") at the directed
    store, plain tier, cached per config."""
    cfg = JConfig(**SMALL, **kw)
    key = (what, cfg)
    if key not in ref["cache"]:
        jb = ref["jb"]
        if what == "out":
            fn = jax.jit(lambda p: j_apply(p, cfg, jb))
        else:
            fn = jax.jit(lambda p: jax.tree.leaves(jax.grad(
                lambda q: j_loss(j_apply(q, cfg, jb), jb, JLoss())[0])(p)))
        ref["cache"][key] = fn(ref["jp"])
    return ref["cache"][key]


# ---------------------------------------------------------------------------
# mirror-map construction
# ---------------------------------------------------------------------------

def _check_maps(bc, bn, bi, pair, sign, rep):
    e = bc.shape[0]
    nu = rep.shape[0]
    assert pair.shape == (e,) and sign.shape == (e,)
    if e == 0:
        assert nu == 0
        return
    assert np.all(np.diff(rep) > 0) if nu > 1 else True
    assert np.all(sign[rep] == 1.0)
    assert np.all(np.bincount(pair[sign > 0], minlength=nu) == 1)
    assert np.all(np.bincount(pair[sign < 0], minlength=nu) <= 1)
    r = rep[pair]
    plus = sign > 0
    same = (bc == bc[r]) & (bn == bn[r]) & np.all(bi == bi[r], axis=1)
    flip = (bc == bn[r]) & (bn == bc[r]) & np.all(bi == -bi[r], axis=1)
    assert np.all(same[plus])
    assert np.all(flip[~plus])


def _graph_pair(arrays, **kw):
    """The port's graph, checked map for map against JAX's."""
    g = build_graph(Crystal(**arrays), **kw)
    jg = jn.build_graph(jn.Crystal(**arrays), **kw)
    for name in ("bond_center", "bond_nbr", "bond_image", "bond_pair",
                 "bond_sign", "und_rep"):
        np.testing.assert_array_equal(getattr(g, name), getattr(jg, name),
                                      err_msg=name)
    _check_maps(g.bond_center, g.bond_nbr, g.bond_image, g.bond_pair,
                g.bond_sign, g.und_rep)
    return g


def test_mirror_maps_symmetric_graph_halves():
    rng = np.random.default_rng(1)
    for _ in range(5):
        g = _graph_pair(_arrays(rng, int(rng.integers(2, 9)), labels=False))
        assert g.bond_pair is not None
        assert 2 * g.num_undirected == g.num_bonds


def test_mirror_maps_self_image_bonds():
    a = dict(lattice=np.eye(3) * 3.0, frac_coords=np.zeros((1, 3)),
             atomic_numbers=np.array([8]))
    g = _graph_pair(a)
    assert g.num_bonds > 0
    assert np.all(g.bond_center == g.bond_nbr)
    assert 2 * g.num_undirected == g.num_bonds


def test_mirror_maps_capped_asymmetry_falls_back():
    rng = np.random.default_rng(7)
    found_asym = False
    for _ in range(12):
        g = _graph_pair(_arrays(rng, int(rng.integers(4, 10)), labels=False),
                        max_nbr_per_atom=3, cap_mode="per_center")
        assert g.num_bonds / 2 <= g.num_undirected <= g.num_bonds
        if 2 * g.num_undirected != g.num_bonds:
            found_asym = True
            refs_minus = np.bincount(g.bond_pair[g.bond_sign < 0],
                                     minlength=g.num_undirected)
            assert np.sum(refs_minus == 0) \
                == 2 * g.num_undirected - g.num_bonds
    assert found_asym, "cap never broke symmetry; weak test inputs"


def test_symmetric_cap_preserves_pair_symmetry():
    rng = np.random.default_rng(7)
    checked_pack = False
    for _ in range(8):
        a = _arrays(rng, int(rng.integers(4, 10)), labels=False)
        c = Crystal(**a)
        g = _graph_pair(a, max_nbr_per_atom=3)
        assert 2 * g.num_undirected == g.num_bonds
        fwd = {(int(x), int(y), *map(int, n))
               for x, y, n in zip(g.bond_center, g.bond_nbr, g.bond_image)}
        assert all((t[1], t[0], *[-x for x in t[2:]]) in fwd for t in fwd)
        gp = build_graph(c, max_nbr_per_atom=3, cap_mode="per_center")
        assert g.num_bonds <= gp.num_bonds
        assert np.bincount(g.bond_center).max(initial=0) <= 3
        if g.num_bonds and not checked_pack:
            caps = BatchCapacities(16, g.num_bonds, g.num_angles + 4)
            validate_layout(batch_crystals([c], [g], caps))
            checked_pack = True
    assert checked_pack


def test_capped_asymmetric_pack_needs_und_override():
    rng = np.random.default_rng(11)
    cs, gs = [], []
    for _ in range(6):
        c = _crystal(rng, 8, labels=False)
        g = build_graph(c, max_nbr_per_atom=3, cap_mode="per_center")
        if 2 * g.num_undirected != g.num_bonds:
            cs.append(c)
            gs.append(g)
    assert cs, "no asymmetric graphs generated"
    bonds = sum(g.num_bonds for g in gs)
    angles = sum(g.num_angles for g in gs)
    und = sum(g.num_undirected for g in gs)
    tight = BatchCapacities(8 * len(cs), bonds, angles)
    if und > tight.und_cap:
        with pytest.raises(ValueError, match="und_bonds"):
            batch_crystals(cs, gs, tight)
    roomy = BatchCapacities(8 * len(cs), bonds, angles, und_bonds=und + 4)
    validate_layout(batch_crystals(cs, gs, roomy))


def test_pack_validates_mirror_invariant(ref):
    batch = ref["tb"]
    validate_layout(batch)
    sign = batch.bond_sign.clone()
    sign[0] = -sign[0]
    with pytest.raises(ValueError, match="mirror|sign"):
        validate_layout(dataclasses.replace(batch, bond_sign=sign))


def test_hand_built_graph_without_maps_is_repaired():
    rng = np.random.default_rng(3)
    c = _crystal(rng, 5, labels=False)
    g = build_graph(c)
    bare = dataclasses.replace(g, bond_pair=None, bond_sign=None,
                               und_rep=None)
    caps = BatchCapacities(8, g.num_bonds + 4, g.num_angles + 4)
    validate_layout(batch_crystals([c], [bare], caps))


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 9),
       st.sampled_from([None, "symmetric", "per_center"]))
def test_mirror_maps_hypothesis_sweep(seed, n, cap_mode):
    """Ragged cells, self-image bonds and both cap modes keep the maps
    total and exact, and equal to JAX's."""
    rng = np.random.default_rng(seed)
    lat = np.eye(3) * rng.uniform(2.2, 6.0) + rng.normal(0, 0.3, (3, 3))
    if abs(np.linalg.det(lat)) < 1.0:
        lat += np.eye(3) * 2.0
    a = dict(lattice=lat, frac_coords=rng.random((n, 3)),
             atomic_numbers=rng.integers(1, 90, n))
    g = _graph_pair(a, max_nbr_per_atom=None if cap_mode is None else 4,
                    cap_mode=cap_mode or "symmetric")
    if cap_mode != "per_center":
        assert 2 * g.num_undirected == g.num_bonds
    cart = Crystal(**a).cart_coords()
    vec_d = cart[g.bond_nbr] + g.bond_image @ lat - cart[g.bond_center]
    rep = g.und_rep
    vec_u = cart[g.bond_nbr[rep]] + g.bond_image[rep] @ lat \
        - cart[g.bond_center[rep]]
    np.testing.assert_allclose(g.bond_sign[:, None] * vec_u[g.bond_pair],
                               vec_d, rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------------------
# model equivalence: undirected == directed per tier, fwd + grad
# ---------------------------------------------------------------------------

TIERS = [
    ("packed", "scatter", "unfused"),
    ("ref", "sorted", "unfused"),
    ("packed", "matmul", "unfused"),
    ("pallas", "pallas", "unfused"),
    ("packed", "scatter", "fused"),
    ("packed", "pallas", "fused"),
]


@pytest.mark.parametrize("mlp_impl,agg_impl,conv_impl", TIERS)
def test_undirected_matches_directed_forward(ref, mlp_impl, agg_impl,
                                             conv_impl):
    cfg = CHGNetConfig(readout="direct", mlp_impl=mlp_impl,
                       agg_impl=agg_impl, conv_impl=conv_impl, **SMALL)
    want = chgnet_apply(ref["tp"], cfg, ref["tb"])
    got = chgnet_apply(ref["tp"], cfg.with_(bond_store="undirected"),
                       ref["tb"])
    jax_out = _jax(ref, "out")
    for k in want:
        tag = f"{k} {mlp_impl}/{agg_impl}/{conv_impl}"
        _close(got[k], want[k], 1e-5, tag)
        _close(got[k], jax_out[k], 1e-5, f"{tag} vs JAX")


def _grads(params, cfg, batch):
    p = params_on(params, "cpu")
    flat = leaves(p)
    loss = chgnet_loss(chgnet_apply(p, cfg, batch), batch, LossWeights())[0]
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(flat, grads)]


@pytest.mark.parametrize("mlp_impl,agg_impl,conv_impl", TIERS)
def test_undirected_matches_directed_gradients(ref, mlp_impl, agg_impl,
                                               conv_impl):
    cfg = CHGNetConfig(readout="direct", mlp_impl=mlp_impl,
                       agg_impl=agg_impl, conv_impl=conv_impl, **SMALL)
    g_d = _grads(ref["tp"], cfg, ref["tb"])
    g_u = _grads(ref["tp"], cfg.with_(bond_store="undirected"), ref["tb"])
    want = _jax(ref, "grad")
    assert len(g_d) == len(g_u) == len(want)
    for i, (a, b, w) in enumerate(zip(g_d, g_u, want)):
        tag = f"leaf {i} {mlp_impl}/{agg_impl}/{conv_impl}"
        _close(b, a, 1e-5, tag)
        _close(b, w, 1e-5, f"{tag} vs JAX")


def test_undirected_matches_directed_autodiff_readout(ref):
    cfg = CHGNetConfig(readout="autodiff", **SMALL)
    jp, tp = _init(1, readout="autodiff")
    want = chgnet_apply(tp, cfg, ref["tb"])
    got = chgnet_apply(tp, cfg.with_(bond_store="undirected"), ref["tb"])
    jax_out = jax.jit(lambda p: j_apply(p, JConfig(readout="autodiff",
                                                   **SMALL), ref["jb"]))(jp)
    for k in want:
        _close(got[k], want[k], 1e-5, f"autodiff/{k}")
        _close(got[k], jax_out[k], 1e-5, f"autodiff/{k} vs JAX")


@pytest.mark.parametrize("precision", ["mixed", "bf16"])
def test_undirected_tracks_directed_under_low_precision(ref, precision):
    cfg = CHGNetConfig(readout="direct", precision=precision, **SMALL)
    want = chgnet_apply(ref["tp"], cfg, ref["tb"])
    got = chgnet_apply(ref["tp"], cfg.with_(bond_store="undirected"),
                       ref["tb"])
    jax_out = _jax(ref, "out", precision=precision)
    for k in want:
        _close(got[k], want[k], 3e-2, f"{precision}/{k}")
        _close(got[k], jax_out[k], 3e-2, f"{precision}/{k} vs JAX")


def test_undirected_serve_engine_end_to_end():
    rng = np.random.default_rng(5)
    crystals = [_crystal(rng, n, labels=False) for n in (4, 5)]
    cfg = CHGNetConfig(readout="direct", bond_store="undirected", **SMALL)
    params = chgnet_init(1, cfg)
    serve = ServeEngine.for_structures(params, cfg, crystals, device="cpu",
                                       validate_layout=True)
    md = BatchedMD(serve, crystals, dt=1e-3)
    out = md.step(3)
    assert md.steps_done == 3
    for f in out["forces"]:
        assert np.all(np.isfinite(np.asarray(f)))
    for r in md.replicas:
        g = r.nlist.update(r.crystal)
        assert 2 * g.num_undirected == g.num_bonds
        _check_maps(g.bond_center, g.bond_nbr, g.bond_image,
                    g.bond_pair, g.bond_sign, g.und_rep)


def test_verlet_update_preserves_canonicalization_under_drift():
    rng = np.random.default_rng(9)
    c = _crystal(rng, 6, labels=False)
    nlist = VerletNeighborList(c, skin=0.4)
    for _ in range(5):
        cart = c.cart_coords() + rng.normal(0, 0.05, (6, 3))
        c.frac_coords = (cart @ np.linalg.inv(c.lattice)) % 1.0
        g = nlist.update(c)
        fresh = build_graph(c)
        assert g.num_bonds == fresh.num_bonds
        assert 2 * g.num_undirected == g.num_bonds
        _check_maps(g.bond_center, g.bond_nbr, g.bond_image,
                    g.bond_pair, g.bond_sign, g.und_rep)


# ---------------------------------------------------------------------------
# equivariance under the undirected store
# ---------------------------------------------------------------------------

def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


@pytest.mark.parametrize("readout", ["direct", "autodiff"])
def test_undirected_forces_rotation_equivariant(readout):
    rng = np.random.default_rng(13)
    c = _crystal(rng, 5, labels=False)
    rot = _rotation(rng)
    g = build_graph(c)
    caps = BatchCapacities(8, g.num_bonds + 4, g.num_angles + 4)
    cfg = CHGNetConfig(readout=readout, bond_store="undirected", **SMALL)
    params = chgnet_init(0, cfg)
    f1 = _np(chgnet_apply(params, cfg, batch_crystals([c], [g], caps))[
        "forces"])
    c2 = Crystal(lattice=c.lattice @ rot.T, frac_coords=c.frac_coords,
                 atomic_numbers=c.atomic_numbers)
    g2 = build_graph(c2)
    assert g2.num_bonds == g.num_bonds
    f2 = _np(chgnet_apply(params, cfg, batch_crystals([c2], [g2], caps))[
        "forces"])
    n = c.num_atoms
    np.testing.assert_allclose(f2[:n], f1[:n] @ rot.T, atol=2e-4)


def test_undirected_translation_invariance():
    rng = np.random.default_rng(17)
    c = _crystal(rng, 5, labels=False)
    g = build_graph(c)
    caps = BatchCapacities(8, g.num_bonds + 4, g.num_angles + 4)
    cfg = CHGNetConfig(readout="direct", bond_store="undirected", **SMALL)
    params = chgnet_init(0, cfg)
    out1 = chgnet_apply(params, cfg, batch_crystals([c], [g], caps))
    shift = rng.random(3)
    c2 = Crystal(lattice=c.lattice, frac_coords=(c.frac_coords + shift) % 1.0,
                 atomic_numbers=c.atomic_numbers)
    g2 = build_graph(c2)
    assert g2.num_bonds == g.num_bonds
    out2 = chgnet_apply(params, cfg, batch_crystals([c2], [g2], caps))
    np.testing.assert_allclose(_np(out2["energy"]), _np(out1["energy"]),
                               atol=1e-4)
    n = c.num_atoms
    np.testing.assert_allclose(_np(out2["forces"])[:n],
                               _np(out1["forces"])[:n], atol=1e-4)


# ---------------------------------------------------------------------------
# training smokes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", ["directed", "undirected"])
def test_pallas_training_descends(store):
    """mlp_impl="pallas" trains (the wrappers' backwards), on the directed
    and the undirected store: six steps on one batch lower the loss."""
    cfg = CHGNetConfig(readout="direct", mlp_impl="pallas", bond_store=store,
                       **SMALL)
    batch = _batch(np.random.default_rng(23), sizes=(5, 6))
    params = params_on(chgnet_init(0, cfg), "cpu")
    opt = adam_init(params)
    train, _, _ = make_chgnet_step_fns(
        cfg, TrainConfig(global_batch=2, total_steps=6, lr_k=1))
    losses = []
    for s in range(6):
        params, opt, m = train(params, opt, batch, s)
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
