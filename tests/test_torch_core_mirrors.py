"""Mirrors of tests/test_basis.py, test_chgnet.py, test_aggregation.py and
test_angle_dedup.py on the port, and of test_donation.py's combined
eval + serve step, with the port's ``param_count``.

Each test asserts on the port what its JAX namesake asserts on the JAX
package.  Where the JAX test computes a value, the same numpy inputs and
the same parameters (the port's seeded ``chgnet_init``, whose tree JAX's
matches leaf for leaf, as numpy arrays; the port's copy through
``convert.params_from_numpy``) also go through the JAX function, and the
port's value is held to it within ``1e-5 * max(1, max|jax|)`` in f32
(DESIGN.md §4's bounds at "mixed").  The JAX side's Pallas tiers are not
run here: the JAX tests hold them to the plain tiers, and the port's
tiers are held to the JAX plain tier.  The finite-difference force check
and the rotation / translation checks of the whole model are in
tests/test_torch_model.py.  Sizes: dim 16, one block, one shared
two-crystal batch."""
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
from repro.configs import chgnet_mptrj as JC  # noqa: E402
from repro.core import basis as jbasis  # noqa: E402
from repro.core import neighbors as jn  # noqa: E402
from repro.core import param_count as j_param_count  # noqa: E402
from repro.core.chgnet import CHGNetConfig as JConfig  # noqa: E402
from repro.core.chgnet import chgnet_apply as j_apply  # noqa: E402
from repro.core.chgnet import chgnet_init as j_init  # noqa: E402
from repro.core.interaction import segment_aggregate as j_agg  # noqa: E402
from repro.core.losses import LossWeights as JLoss  # noqa: E402
from repro.core.losses import chgnet_loss as j_loss  # noqa: E402
from repro.train.trainer import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.trainer import make_chgnet_eval_serve_step as j_es  # noqa: E402
from repro_torch.batching import BatchCapacities as TCaps  # noqa: E402
from repro_torch.batching import batch_crystals as t_pack  # noqa: E402
from repro_torch.batching import validate_layout  # noqa: E402
from repro_torch.configs import chgnet_mptrj as TC  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import basis as tbasis  # noqa: E402
from repro_torch.core import neighbors as tn  # noqa: E402
from repro_torch.core import param_count  # noqa: E402
from repro_torch.core.chgnet import CHGNetConfig, chgnet_apply, chgnet_init  # noqa: E402
from repro_torch.core.interaction import segment_aggregate  # noqa: E402
from repro_torch.core.losses import LossWeights, chgnet_loss  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.train import (  # noqa: E402
    TrainConfig, make_chgnet_eval_serve_step, make_chgnet_step_fns,
)

SMALL = dict(dim=16, num_blocks=1, num_rbf=7, num_fourier=7)
IMPLS = ("scatter", "matmul", "sorted", "pallas")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, atol=1e-5, msg=""):
    """Within ``atol * max(1, max|want|)`` (the scaled form of
    tests/test_bond_store.py)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale,
                               err_msg=msg)


def _arrays(seed, ns, labels=True, scale=4.3):
    rng = np.random.default_rng(seed)
    out = []
    for n in ns:
        kw = dict(lattice=np.eye(3) * scale + rng.normal(0, .05, (3, 3)),
                  frac_coords=rng.random((n, 3)),
                  atomic_numbers=rng.integers(1, 90, n))
        if labels:
            kw.update(energy=float(rng.normal()),
                      forces=rng.normal(0, .1, (n, 3)),
                      stress=rng.normal(0, .1, (3, 3)),
                      magmoms=np.abs(rng.normal(0, 1, n)))
        out.append(kw)
    return out


def _pair(arrays, pad=(4, 8, 8), slots=None):
    """The JAX batch and the port's batch of the same crystals and
    capacities, and the port's crystals and graphs."""
    jc = [jn.Crystal(**a) for a in arrays]
    tc = [tn.Crystal(**a) for a in arrays]
    jg = [jn.build_graph(c) for c in jc]
    tg = [tn.build_graph(c) for c in tc]
    caps = (sum(c.num_atoms for c in jc) + pad[0],
            sum(g.num_bonds for g in jg) + pad[1],
            sum(g.num_angles for g in jg) + pad[2])
    return (j_pack(jc, jg, JCaps(*caps), num_crystal_slots=slots),
            t_pack(tc, tg, TCaps(*caps), num_crystal_slots=slots), tc, tg)


def _init(seed, **kw):
    """One parameter tree for both packages: JAX's, and the port's copy
    (JAX's own init is slow eagerly on the CPU)."""
    src = jax.tree.map(lambda t: t.numpy(),
                       chgnet_init(seed, CHGNetConfig(**SMALL, **kw)))
    return jax.tree.map(jnp.asarray, src), params_from_numpy(src)


@pytest.fixture(scope="module")
def shared():
    """test_chgnet.py's two-crystal batch (5 and 7 atoms, labelled), in
    both packages, with one parameter tree per readout."""
    jb, tb, tc, tg = _pair(_arrays(0, (5, 7)))
    params = {}
    for readout in ("direct", "autodiff"):
        params[readout] = _init(0, readout=readout)
    return dict(jb=jb, tb=tb, tc=tc, tg=tg, params=params, jax_out={})


def _cfgs(**kw):
    return JConfig(**SMALL, **kw), CHGNetConfig(**SMALL, **kw)


def _jax_out(shared, readout="direct", **kw):
    """JAX's forward on the shared batch, computed once per config."""
    jcfg = _cfgs(readout=readout, **kw)[0]
    if jcfg not in shared["jax_out"]:
        shared["jax_out"][jcfg] = jax.jit(lambda p, b: j_apply(p, jcfg, b))(
            shared["params"][readout][0], shared["jb"])
    return shared["jax_out"][jcfg]


# ---------------------------------------------------------------------------
# tests/test_basis.py
# ---------------------------------------------------------------------------

@given(st.lists(st.floats(0.0, 1.0, width=32), min_size=1, max_size=64),
       st.sampled_from([4, 6, 8, 12]))
@settings(max_examples=10, deadline=None)
def test_envelope_factored_equals_reference(xs, p):
    """Eq. 13 (factored) equals Eq. 12, and each equals JAX's."""
    xi = np.asarray(xs, np.float32)
    ref = tbasis.envelope_reference(torch.from_numpy(xi), p)
    fac = tbasis.envelope_factored(torch.from_numpy(xi), p)
    np.testing.assert_allclose(_np(ref), _np(fac), rtol=1e-4, atol=2e-4)
    # JAX on the values padded to the sweep's longest list: one shape,
    # so its eager ops compile once (elementwise: padding changes none)
    xj = jnp.asarray(np.pad(xi, (0, 64 - xi.size)))
    _close(ref, jbasis.envelope_reference(xj, p)[:xi.size])
    _close(fac, jbasis.envelope_factored(xj, p)[:xi.size])


def test_envelope_smooth_cutoff():
    """u(1) = u'(1) = 0 and u(0) = 1, as in JAX."""
    for p in (6, 8):
        x = torch.tensor(1.0, requires_grad=True)
        u = tbasis.envelope_factored(x, p)
        (du,) = torch.autograd.grad(u, x)
        assert abs(float(u.detach())) < 1e-5
        assert abs(float(du)) < 1e-4
        _close(u, jbasis.envelope_factored(jnp.asarray(1.0), p))
        _close(du, jax.grad(lambda v: jbasis.envelope_factored(v, p))(
            jnp.asarray(1.0)))
    assert abs(float(tbasis.envelope_factored(torch.tensor(0.0), 8))
               - 1.0) < 1e-6


@pytest.mark.parametrize("n", [1, 31, 64])
def test_smooth_rbf_shapes_and_finiteness(n):
    r = np.linspace(0.1, 6.0, 57, dtype=np.float32)
    freqs = tbasis.rbf_frequencies(n)
    out = tbasis.smooth_rbf(torch.from_numpy(r), freqs, 6.0, 8)
    assert out.shape == (57, n)
    assert bool(torch.isfinite(out).all())
    _close(out, jbasis.smooth_rbf(jnp.asarray(r), jbasis.rbf_frequencies(n),
                                  6.0, 8))
    edge = tbasis.smooth_rbf(torch.tensor([6.0]), freqs, 6.0, 8)
    assert float(edge.abs().max()) < 1e-5


def test_smooth_rbf_padded_zero_distance_safe():
    r = np.array([0.0, 3.0], np.float32)
    out = tbasis.smooth_rbf(torch.from_numpy(r), tbasis.rbf_frequencies(8),
                            6.0)
    assert bool(torch.isfinite(out).all())
    _close(out, jbasis.smooth_rbf(jnp.asarray(r), jbasis.rbf_frequencies(8),
                                  6.0))


def test_fourier_basis_values():
    th = np.array([0.3, 1.2], np.float32)
    out = tbasis.fourier_basis(torch.from_numpy(th), 31)
    assert out.shape == (2, 31)
    np.testing.assert_allclose(_np(out[:, 0]), 1 / np.sqrt(2) / np.sqrt(np.pi),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(out[:, 1]), np.cos(th) / np.sqrt(np.pi),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(out[:, 16]), np.sin(th) / np.sqrt(np.pi),
                               rtol=1e-5)
    _close(out, jbasis.fourier_basis(jnp.asarray(th), 31))


def test_geometry_differentiable_and_consistent():
    rng = np.random.default_rng(3)
    a = dict(lattice=np.eye(3) * 4.5, frac_coords=rng.random((4, 3)),
             atomic_numbers=rng.integers(1, 10, 4))
    c, jc = tn.Crystal(**a), jn.Crystal(**a)
    g, jg = tn.build_graph(c), jn.build_graph(jc)
    batch = t_pack([c], [g], TCaps(8, 512, 2048))
    jbatch = j_pack([jc], [jg], JCaps(8, 512, 2048))
    vec, dist, cos_t, theta = tbasis.compute_geometry(batch)
    cart = c.cart_coords()
    v0 = cart[g.bond_nbr] + g.bond_image @ c.lattice - cart[g.bond_center]
    np.testing.assert_allclose(_np(dist[:g.num_bonds]),
                               np.linalg.norm(v0, axis=-1), rtol=1e-4)
    for got, want in zip((vec, dist, cos_t, theta),
                         jax.jit(jbasis.compute_geometry)(jbatch)):
        _close(got, want)
    strain = torch.zeros((1, 3, 3), requires_grad=True)
    (gs,) = torch.autograd.grad(
        tbasis.compute_geometry(batch, strain=strain)[1].sum(), strain)
    assert bool(torch.isfinite(gs).all())
    _close(gs, jax.jit(jax.grad(lambda s: jnp.sum(
        jbasis.compute_geometry(jbatch, strain=s)[1])))(
            jnp.zeros((1, 3, 3), jnp.float32)))


# ---------------------------------------------------------------------------
# tests/test_chgnet.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("readout", ["direct", "autodiff"])
@pytest.mark.parametrize("variant", ["fast", "reference"])
def test_forward_shapes_no_nan(shared, readout, variant):
    tb = shared["tb"]
    cfg = _cfgs(readout=readout, block_variant=variant)[1]
    out = chgnet_apply(shared["params"][readout][1], cfg, tb)
    assert out["energy"].shape == (2,)
    assert out["forces"].shape == (tb.atom_cap, 3)
    assert out["stress"].shape == (2, 3, 3)
    assert out["magmom"].shape == (tb.atom_cap,)
    want = _jax_out(shared, readout, block_variant=variant)
    for k, v in out.items():
        assert bool(torch.isfinite(v).all()), k
        _close(v, want[k], msg=k)


@pytest.mark.parametrize("name", [
    n for n in vars(TC) if isinstance(getattr(TC, n), CHGNetConfig)])
def test_param_count_matches_jax(name):
    """``param_count`` equals JAX's on every config of chgnet_mptrj."""
    got = param_count(chgnet_init(0, getattr(TC, name)))
    # JAX's count on the tree's shapes (nothing drawn)
    assert got == j_param_count(jax.eval_shape(
        lambda: j_init(jax.random.PRNGKey(0), getattr(JC, name))))


def test_param_count_near_paper():
    """Paper Table I: 429.1K (F/S head) / 412.5K (reference)."""
    direct = param_count(chgnet_init(0, CHGNetConfig(readout="direct")))
    auto = param_count(chgnet_init(0, CHGNetConfig(readout="autodiff")))
    assert abs(direct - 429_100) / 429_100 < 0.05
    assert abs(auto - 412_500) / 412_500 < 0.05
    assert direct > auto


def test_fast_and_reference_blocks_differ_but_are_close_at_init(shared):
    tb, p = shared["tb"], shared["params"]["direct"][1]
    e_f = chgnet_apply(p, _cfgs(block_variant="fast")[1], tb)["energy"]
    e_r = chgnet_apply(p, _cfgs(block_variant="reference")[1], tb)["energy"]
    assert not torch.allclose(e_f, e_r)
    _close(e_r, _jax_out(shared, block_variant="reference")["energy"])


def test_mlp_impls_agree(shared):
    tb, p = shared["tb"], shared["params"]["direct"][1]
    outs = {impl: chgnet_apply(p, _cfgs(mlp_impl=impl)[1], tb)
            for impl in ("ref", "packed", "pallas")}
    want = _jax_out(shared)
    for k in outs["ref"]:
        np.testing.assert_allclose(_np(outs["ref"][k]),
                                   _np(outs["packed"][k]), atol=1e-5)
        np.testing.assert_allclose(_np(outs["packed"][k]),
                                   _np(outs["pallas"][k]), atol=2e-4)
        for impl, out in outs.items():
            _close(out[k], want[k], msg=f"{impl} {k}")


def test_agg_impls_agree(shared):
    tb, p = shared["tb"], shared["params"]["direct"][1]
    a = chgnet_apply(p, _cfgs(agg_impl="scatter")[1], tb)
    b = chgnet_apply(p, _cfgs(agg_impl="matmul")[1], tb)
    want = _jax_out(shared)
    for k in a:
        np.testing.assert_allclose(_np(a[k]), _np(b[k]), atol=1e-4)
        _close(b[k], want[k], msg=k)


def test_energy_extensive_under_padding(shared):
    """Extra padding capacity changes no prediction."""
    tb, p = shared["tb"], shared["params"]["direct"][1]
    big = (tb.atom_cap + 32, tb.bond_cap + 64, tb.angle_cap + 64)
    tb2 = t_pack(shared["tc"], shared["tg"], TCaps(*big))
    cfg = _cfgs()[1]
    o1, o2 = chgnet_apply(p, cfg, tb), chgnet_apply(p, cfg, tb2)
    for k in ("energy", "stress"):
        np.testing.assert_allclose(_np(o1[k]), _np(o2[k]), atol=1e-4)
        _close(o2[k], _jax_out(shared)[k], msg=k)


@pytest.mark.parametrize("readout", ["direct", "autodiff"])
def test_loss_and_grads_finite_all_variants(shared, readout):
    """Every gradient leaf finite, and equal to jax.grad's."""
    jp = shared["params"][readout][0]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jcfg, tcfg = _cfgs(readout=readout)
    jb, tb = shared["jb"], shared["tb"]
    flat = [x.requires_grad_() for x in leaves(tp)]
    loss = chgnet_loss(chgnet_apply(tp, tcfg, tb), tb, LossWeights())[0]
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    want = jax.jit(jax.grad(lambda p: j_loss(j_apply(p, jcfg, jb), jb,
                                             JLoss())[0]))(jp)
    for g, w, x in zip(grads, jax.tree.leaves(want), flat):
        g = torch.zeros_like(x) if g is None else g
        assert bool(torch.isfinite(g).all())
        _close(g, w)


# ---------------------------------------------------------------------------
# tests/test_aggregation.py
# ---------------------------------------------------------------------------

def _random_sorted_layout(rng, num_edges, num_segments, dim, n_real):
    ids = np.sort(rng.integers(0, num_segments, n_real)).astype(np.int32)
    seg = np.zeros(num_edges, np.int32)
    seg[:n_real] = ids
    offsets = np.searchsorted(ids, np.arange(num_segments + 1)).astype(
        np.int32)
    mask = np.zeros(num_edges, np.float32)
    mask[:n_real] = 1.0
    values = rng.normal(0, 1, (num_edges, dim)).astype(np.float32)
    return values, seg, mask, offsets


def _agg_case(num_edges, num_segments, dim, n_real, seed):
    v, seg, mask, offs = _random_sorted_layout(
        np.random.default_rng(seed), num_edges, num_segments, dim, n_real)
    want = j_agg(jnp.asarray(v), jnp.asarray(seg), num_segments,
                 jnp.asarray(mask), "scatter")
    t = [torch.from_numpy(a) for a in (v, seg, mask, offs)]
    base = segment_aggregate(t[0], t[1], num_segments, t[2], "scatter")
    _close(base, want, msg="scatter")
    for impl in IMPLS[1:]:
        got = segment_aggregate(t[0], t[1], num_segments, t[2], impl,
                                offsets=t[3])
        np.testing.assert_allclose(_np(got), _np(base), rtol=1e-5,
                                   atol=1e-5, err_msg=impl)


@pytest.mark.parametrize("num_edges,num_segments,dim,n_real", [
    (256, 32, 64, 200),
    (100, 17, 8, 100),
    (64, 9, 33, 0),
    (513, 200, 64, 400),
])
def test_impls_agree_on_random_layouts(num_edges, num_segments, dim, n_real):
    _agg_case(num_edges, num_segments, dim, n_real, num_edges + n_real)


def test_pallas_impl_requires_offsets():
    v, seg, mask = torch.zeros((8, 4)), torch.zeros(8, dtype=torch.int32), \
        torch.ones(8)
    with pytest.raises(ValueError, match="offsets"):
        segment_aggregate(v, seg, 4, mask, "pallas")
    assert segment_aggregate(v, seg, 4, mask, "sorted").shape == (4, 4)


def test_pallas_gradient_matches_scatter():
    v, seg, mask, offs = _random_sorted_layout(np.random.default_rng(3), 128,
                                               16, 32, 100)
    jg = jax.grad(lambda vv: jnp.sum(
        (o := j_agg(vv, jnp.asarray(seg), 16, jnp.asarray(mask),
                    "scatter")) * jnp.cos(o)))(jnp.asarray(v))
    seg_t, mask_t, offs_t = (torch.from_numpy(a) for a in (seg, mask, offs))
    for impl in ("scatter", "sorted", "pallas"):
        vv = torch.from_numpy(v).requires_grad_()
        out = segment_aggregate(vv, seg_t, 16, mask_t, impl, offsets=offs_t)
        (g,) = torch.autograd.grad((out * torch.cos(out)).sum(), vv)
        _close(g, jg, msg=impl)


@settings(max_examples=10, deadline=None)
@given(num_segments=st.integers(1, 40), dim=st.integers(1, 80),
       n_real=st.integers(0, 120), pad=st.integers(0, 50),
       seed=st.integers(0, 2**31 - 1))
def test_impls_agree_property(num_segments, dim, n_real, pad, seed):
    _agg_case(n_real + pad + 1, num_segments, dim, n_real, seed)


@pytest.fixture(scope="module")
def packed():
    """test_aggregation.py's three-crystal batch (5, 7, 4 atoms)."""
    jb, tb, _, _ = _pair(_arrays(0, (5, 7, 4), labels=False, scale=4.4),
                         pad=(8, 32, 48))
    jp, tp = _init(0)
    want = jax.jit(lambda p, b: j_apply(p, JConfig(**SMALL), b))(jp, jb)
    return tb, tp, want


def test_packed_batch_satisfies_layout(packed):
    validate_layout(packed[0])


def test_validate_layout_rejects_unsorted(packed):
    batch = packed[0]
    bc = batch.bond_center.clone()
    n_real = int(batch.bond_mask.sum())
    bc[0], bc[n_real - 1] = bc[n_real - 1].clone(), bc[0].clone()
    with pytest.raises(ValueError, match="layout"):
        validate_layout(dataclasses.replace(batch, bond_center=bc))


def test_validate_layout_rejects_bad_offsets(packed):
    batch = packed[0]
    offs = batch.bond_offsets.clone()
    offs[1] += 1
    with pytest.raises(ValueError, match="offsets"):
        validate_layout(dataclasses.replace(batch, bond_offsets=offs))


@pytest.mark.parametrize("impl", IMPLS[1:])
def test_chgnet_apply_matches_across_agg_impls(packed, impl):
    """End-to-end outputs of each aggregation impl against JAX's scatter
    tier within 1e-5."""
    tb, tp, want = packed
    got = chgnet_apply(tp, CHGNetConfig(agg_impl=impl, **SMALL), tb)
    for k in want:
        _close(got[k], want[k], msg=f"{impl}:{k}")


def _random_rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


@pytest.mark.parametrize("impl", ["sorted", "pallas"])
def test_force_rotation_equivariance_sorted_layout(impl):
    """F(Rx) = R F(x) under the sorted layout."""
    rng = np.random.default_rng(7)
    a = _arrays(7, (5,), labels=False, scale=4.4)[0]
    c = tn.Crystal(**a)
    rot = _random_rotation(rng)
    g = tn.build_graph(c)
    caps = TCaps(8, g.num_bonds + 4, g.num_angles + 4)
    cfg = CHGNetConfig(readout="direct", agg_impl=impl, **SMALL)
    params = chgnet_init(0, cfg)
    f1 = _np(chgnet_apply(params, cfg, t_pack([c], [g], caps))["forces"])
    c2 = tn.Crystal(lattice=c.lattice @ rot.T, frac_coords=c.frac_coords,
                    atomic_numbers=c.atomic_numbers)
    g2 = tn.build_graph(c2)
    f2 = _np(chgnet_apply(params, cfg, t_pack([c2], [g2], caps))["forces"])
    n = c.num_atoms
    np.testing.assert_allclose(f2[:n], f1[:n] @ rot.T, atol=2e-4)


# ---------------------------------------------------------------------------
# tests/test_angle_dedup.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dedup():
    return _pair(_arrays(7, (5, 6, 4), labels=False, scale=3.6))


def test_map_construction_halves_symmetric_lists():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(3, 9))
        a = dict(lattice=np.eye(3) * 3.6 + rng.normal(0, .05, (3, 3)),
                 frac_coords=rng.random((n, 3)),
                 atomic_numbers=rng.integers(1, 60, n))
        g = tn.build_graph(tn.Crystal(**a))
        if g.num_angles == 0:
            continue
        jg = jn.build_graph(jn.Crystal(**a))
        np.testing.assert_array_equal(g.angle_pair, jg.angle_pair)
        np.testing.assert_array_equal(g.und_angle_rep, jg.und_angle_rep)
        na, nu = g.num_angles, g.und_angle_rep.shape[0]
        assert na == 2 * nu
        assert np.all(np.bincount(g.angle_pair, minlength=nu) == 2)
        assert np.all(g.angle_pair[g.und_angle_rep] == np.arange(nu))
        lo = np.minimum(g.angle_ij, g.angle_ik)
        hi = np.maximum(g.angle_ij, g.angle_ik)
        key = lo.astype(np.int64) << 32 | hi
        for u in range(nu):
            assert len(set(key[g.angle_pair == u])) == 1


def test_singleton_fallback_total():
    ij = np.array([0, 1, 3], np.int32)
    ik = np.array([1, 0, 4], np.int32)
    pair, rep = tn.build_angle_mirror_maps(ij, ik)
    jpair, jrep = jn.build_angle_mirror_maps(ij, ik)
    np.testing.assert_array_equal(pair, jpair)
    np.testing.assert_array_equal(rep, jrep)
    assert rep.shape[0] == 2
    assert pair[0] == pair[1] != pair[2]
    assert np.all(pair[rep] == np.arange(2))
    p0, r0 = tn.build_angle_mirror_maps(ij[:0], ik[:0])
    assert p0.shape == (0,) and r0.shape == (0,)


def test_dedup_rows_expand_exactly(dedup):
    jb, batch = dedup[:2]
    *_, cos_d, theta_d = tbasis.compute_geometry_undirected(
        batch, angle_rows="directed")
    *_, cos_u, theta_u = tbasis.compute_geometry_undirected(
        batch, angle_rows="undirected")
    mask = _np(batch.angle_mask) > 0
    pair = _np(batch.angle_pair)
    assert np.array_equal(_np(cos_u)[pair][mask], _np(cos_d)[mask])
    assert np.array_equal(_np(theta_u)[pair][mask], _np(theta_d)[mask])
    *_, cos_ref, _ = tbasis.compute_geometry(batch)
    np.testing.assert_allclose(_np(cos_d)[mask], _np(cos_ref)[mask],
                               atol=1e-6)
    want = jax.jit(lambda b: jbasis.compute_geometry_undirected(
        b, angle_rows="undirected"))(jb)
    _close(cos_u, want[-2])
    _close(theta_u, want[-1])


def test_validate_layout_rejects_tampered_angle_maps(dedup):
    batch = dedup[1]
    validate_layout(batch)
    ap = batch.angle_pair.clone()
    u0 = int(ap[0])
    u1 = int(ap[ap != u0][0])  # a real angle of another pair
    ap[0] = u1
    with pytest.raises(ValueError):
        validate_layout(dataclasses.replace(batch, angle_pair=ap))
    uij, uik = batch.und_angle_ij.clone(), batch.und_angle_ik.clone()
    uij[u0], uik[u0] = uik[u0].clone(), uij[u0] + 1
    with pytest.raises(ValueError):
        validate_layout(dataclasses.replace(batch, und_angle_ij=uij,
                                            und_angle_ik=uik))


def test_capacity_overflow_carries_und_angles():
    caps = TCaps(64, 256, 512, und_angles=300)
    assert caps.und_angle_cap == 300
    assert caps.scaled(2).und_angle_cap == 600
    assert caps.fits(10, 20, 30, n_und_angles=299)
    assert not caps.fits(10, 20, 30, n_und_angles=301)


# ---------------------------------------------------------------------------
# tests/test_donation.py: the combined eval + serve step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", ["directed", "symmetric"])
def test_eval_serve_step(shared, store):
    """ONE forward gives (metrics, outputs): equal to JAX's undonated
    step within 1e-5, and bit for bit to the port's own eval_step and
    serve_step, on the directed and the symmetric trunk."""
    kw = dict(bond_store="undirected", bond_features="undirected") \
        if store == "symmetric" else {}
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = shared["params"]["direct"]
    jtrain = JTrainConfig(global_batch=2, total_steps=10)
    train = TrainConfig(global_batch=2, total_steps=10)
    want_m, want_o = j_es(jcfg, jtrain, donate=False)(jp, shared["jb"])
    step = make_chgnet_eval_serve_step(tcfg, train)
    metrics, out = step(tp, shared["tb"])
    _, eval_step, serve_step = make_chgnet_step_fns(tcfg, train)
    sep_m, sep_o = eval_step(tp, shared["tb"]), serve_step(tp, shared["tb"])
    assert metrics.keys() == sep_m.keys() == want_m.keys()
    assert out.keys() == sep_o.keys() == want_o.keys()
    assert np.isfinite(float(metrics["loss"]))
    for k in metrics:
        assert torch.equal(metrics[k], sep_m[k]), k
        _close(metrics[k], want_m[k], msg=k)
    for k in out:
        assert not out[k].requires_grad
        assert torch.equal(out[k], sep_o[k]), k
        _close(out[k], want_o[k], msg=k)
