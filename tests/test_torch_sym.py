"""The port's undirected bond store (DESIGN.md §5) and symmetric
half-graph trunk (§10) against the JAX package on the CPU.

Op level: the mirror operands of the atom conv (``pair``, ``pair`` +
``und_features``) and of the bond conv (``pair``), and the symmetric bond
conv, forward against the Pallas kernels in interpret mode and gradients
against ``jax.vjp`` of the JAX wrappers, on layouts with a self-image pair
(du1 == du2), an Eu row with no incidences and a padded tail; phases A and
B of the symmetric bond conv apart; a float64 double backward.  Model
level: the undirected geometry, the forward and every gradient leaf at
FAST_HALF, FAST_FUSED_HALF, FAST_SYM and FAST_FUSED_SYM, the undirected
bond-virial head, the autodiff readout on the symmetric trunk, serving,
and FAST_FUSED_HALF against the port's own FAST_FUSED.  The JAX side runs
the unfused twin of a fused config (FAST_HALF for FAST_FUSED_HALF,
FAST_SYM for FAST_FUSED_SYM), which tests/test_sym_features.py holds to
its fused tier.  Widths are narrow (dim 16); the tolerance is the port's,
rtol 1e-4 and atol 1e-5 (1e-5 for the ops)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.batching import BatchCapacities as JCaps  # noqa: E402
from repro.batching import batch_crystals as j_pack  # noqa: E402
from repro.configs import chgnet_mptrj as JC  # noqa: E402
from repro.core import basis as jbasis  # noqa: E402
from repro.core import losses as jl  # noqa: E402
from repro.core import neighbors as jn  # noqa: E402
from repro.core.chgnet import chgnet_apply as j_apply  # noqa: E402
from repro.core.chgnet import chgnet_init as j_init  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.serve import BatchedMD as JMD  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch.batching import BatchCapacities as TCaps  # noqa: E402
from repro_torch.batching import batch_crystals as t_pack  # noqa: E402
from repro_torch.configs import chgnet_mptrj as TC  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import CHGNet, basis as tbasis, neighbors as tn  # noqa: E402
from repro_torch.core.chgnet import chgnet_apply  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.serve import BatchedMD, ServeEngine  # noqa: E402
from repro_torch.train import trainer as ttrain  # noqa: E402

SMALL = dict(dim=16, num_blocks=2, num_rbf=7, num_fourier=7)
TOL = dict(rtol=1e-4, atol=1e-5)
OP_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_kernels.py's
# the port's config -> the JAX config it is held to
TWIN = {"FAST_HALF": "FAST_HALF", "FAST_FUSED_HALF": "FAST_HALF",
        "FAST_SYM": "FAST_SYM", "FAST_FUSED_SYM": "FAST_SYM"}


# ---------------------------------------------------------------------------
# op level
# ---------------------------------------------------------------------------

def _f(rng, *shape):
    return rng.normal(0, 1, shape).astype(np.float32)


def _mlp(rng, d_in, d):
    return (rng.normal(0, 0.1, (d_in, 2 * d)).astype(np.float32),
            rng.normal(0, 1, 2 * d).astype(np.float32),
            rng.uniform(.5, 1.5, 2 * d).astype(np.float32),
            rng.normal(0, 1, 2 * d).astype(np.float32))


def _csr(rng, rows, n_edges, n_real):
    seg = np.zeros(n_edges, np.int32)
    seg[:n_real] = np.sort(rng.integers(0, rows, n_real))
    offs = np.searchsorted(seg[:n_real], np.arange(rows + 1))
    return seg, offs.astype(np.int32)


def atom_mirror_inputs(rng, und, a=9, e_rows=40, eu=23, d=8, n_real=34):
    """Atom conv operands on the undirected store: e_a (and with ``und``
    e) at Eu rows, read through a pair map; padded bonds carry pair 0."""
    seg, offs = _csr(rng, a, e_rows, n_real)
    pair = np.zeros(e_rows, np.int32)
    pair[:n_real] = rng.integers(0, eu, n_real)
    args = (_f(rng, a, d), _f(rng, eu if und else e_rows, d), _f(rng, eu, d)) \
        + _mlp(rng, 3 * d, d) \
        + (seg, rng.integers(0, a, e_rows).astype(np.int32), offs)
    return args, dict(pair=pair, und_features=und)


def bond_pair_inputs(rng, a=7, b_rows=19, eu=11, n_ang=45, d=8, n_real=38):
    seg, offs = _csr(rng, b_rows, n_ang, n_real)
    pair = rng.integers(0, eu, b_rows).astype(np.int32)
    args = (_f(rng, a, d), _f(rng, b_rows, d), _f(rng, n_ang, d),
            _f(rng, eu, d)) + _mlp(rng, 4 * d, d) \
        + (seg, rng.integers(0, b_rows, n_ang).astype(np.int32),
           rng.integers(0, a, n_ang).astype(np.int32), offs)
    return args, dict(pair=pair)


def sym_inputs(rng, a=7, eu=13, au=24, n_real=17, d=8):
    """Symmetric bond conv operands: ``n_real`` dedup rows of ``au``, one
    a self-image pair (du1 == du2), Eu row ``eu - 1`` on no incidence; the
    dest-sorted incidence store as the packer builds it (two incidences
    per real row, padded ones rep 0 / dest 0)."""
    du1 = rng.integers(0, eu - 1, au).astype(np.int32)
    du2 = rng.integers(0, eu - 1, au).astype(np.int32)
    du2[3] = du1[3]
    du1[n_real:] = du2[n_real:] = 0
    dest = np.concatenate([du1[:n_real], du2[:n_real]])
    rep = np.concatenate([np.arange(n_real, dtype=np.int32)] * 2)
    order = np.argsort(dest, kind="stable")
    sym_dest = np.zeros(2 * au, np.int32)
    sym_rep = np.zeros(2 * au, np.int32)
    sym_dest[:2 * n_real] = dest[order]
    sym_rep[:2 * n_real] = rep[order]
    offs = np.searchsorted(sym_dest[:2 * n_real],
                           np.arange(eu + 1)).astype(np.int32)
    assert offs[-1] - offs[-2] == 0  # the empty Eu row
    ctr = rng.integers(0, a, au).astype(np.int32)
    return (_f(rng, a, d), _f(rng, eu, d), _f(rng, au, d), _f(rng, eu, d)) \
        + _mlp(rng, 4 * d, d) + (ctr, du1, du2, sym_rep, sym_dest, offs)


def _jax_kw(kw):
    return {k: jnp.asarray(x) if isinstance(x, np.ndarray) else x
            for k, x in kw.items()}


def _torch_kw(kw):
    return {k: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
            for k, x in kw.items()}


OPS = {
    "atom_conv[pair]": ("fused_atom_conv",
                        lambda r: atom_mirror_inputs(r, False)),
    "atom_conv[pair+und]": ("fused_atom_conv",
                            lambda r: atom_mirror_inputs(r, True)),
    "bond_conv[pair]": ("fused_bond_conv", bond_pair_inputs),
    "sym_bond_conv": ("fused_sym_bond_conv", lambda r: (sym_inputs(r), {})),
}


@pytest.mark.parametrize("case", list(OPS))
def test_op_forward_and_vjp_match_jax(case):
    """Forward against the JAX wrapper (Pallas interpret mode) and its jnp
    oracle; the cotangent of every float input against ``jax.vjp`` of the
    JAX wrapper, with one backward chunk and with chunks of 5 rows."""
    name, make = OPS[case]
    rng = np.random.default_rng(len(case))
    args, kw = make(rng)
    idx = [i for i, x in enumerate(args) if x.dtype == np.float32]

    def call(fn, floats, lib, extra):
        full = [lib(x) for x in args]
        for i, t in zip(idx, floats):
            full[i] = t
        return fn(*full, **extra)

    out, vjp = jax.vjp(
        lambda *f: call(getattr(jops, name), f, jnp.asarray, _jax_kw(kw)),
        *[jnp.asarray(args[i]) for i in idx])
    want_ref = getattr(jref, f"{name}_ref")(*map(jnp.asarray, args),
                                            **_jax_kw(kw))
    cot = rng.normal(0, 1, out.shape).astype(np.float32)
    want = vjp(jnp.asarray(cot))
    tops.reset_launch_counts()
    for chunk in (None, 5):
        floats = [torch.from_numpy(args[i]).requires_grad_() for i in idx]
        got = call(getattr(tops, name), floats, torch.from_numpy,
                   dict(_torch_kw(kw), chunk=chunk))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                                   **OP_TOL)
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(want_ref), **OP_TOL)
        grads = torch.autograd.grad(got, floats, torch.from_numpy(cot))
        for i, g, w in zip(idx, grads, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"input {i}, chunk {chunk}",
                                       **OP_TOL)
    # CPU tensors run the plain versions: no kernel is launched
    assert not any(tops.launch_counts().values())


def test_sym_phases_compose_and_skip_padding():
    """Phase A's real rows against a numpy evaluation of its formula;
    phase B of them equals the whole symmetric bond conv; the padded
    incidences (rep 0, a real row) and the padded dedup rows add nothing;
    the self-image row lands twice on its one bond."""
    rng = np.random.default_rng(4)
    args = sym_inputs(rng)
    (v, e, a_u, e_b, w, b, lns, lnb, ctr, du1, du2, rep, dest,
     offs) = map(torch.from_numpy, args)
    n_real = int(offs[-1]) // 2
    msg = tops.sym_msg(v, e, a_u, e_b, w, b, lns, lnb, ctr, du1, du2, offs)
    assert msg.shape == a_u.shape
    e_s = e[du1.long()] + e[du2.long()]
    x = torch.cat([v[ctr.long()], e_s, e_s, a_u], dim=-1)
    want = tref.gated_mlp_packed_ref(x, w, b, lns, lnb) \
        * e_b[du1.long()] * e_b[du2.long()]
    np.testing.assert_allclose(msg[:n_real].numpy(), want[:n_real].numpy(),
                               **OP_TOL)
    agg = tops.sym_accum(msg, rep, dest, offs, e.shape[0])
    np.testing.assert_array_equal(
        agg.numpy(), tops.fused_sym_bond_conv(*map(torch.from_numpy,
                                                   args)).detach().numpy())
    np.testing.assert_allclose(
        agg.numpy(), np.asarray(jref.fused_sym_bond_conv_ref(
            *map(jnp.asarray, args))), **OP_TOL)
    garbage = msg.clone()
    garbage[n_real:] = 1e6
    np.testing.assert_array_equal(
        tops.sym_accum(garbage, rep, dest, offs, e.shape[0]).numpy(),
        agg.numpy())
    self_row = 3
    u = int(du1[self_row])
    hits = (dest[:2 * n_real] == u) & (rep[:2 * n_real] == self_row)
    assert int(hits.sum()) == 2
    assert not agg[-1].any()  # the Eu row with no incidences


def test_sym_bond_conv_is_twice_differentiable():
    """float64 ``gradgradcheck`` through ``_SymBondConv``'s recompute
    backward (the autodiff readout on the symmetric trunk needs it)."""
    rng = np.random.default_rng(6)
    args = sym_inputs(rng, a=4, eu=6, au=9, n_real=6, d=4)
    floats = [torch.from_numpy(x).double().requires_grad_()
              for x in args[:8]]
    ids = [torch.from_numpy(x) for x in args[8:]]

    def f(*xs):
        return tops.fused_sym_bond_conv(*xs, *ids, chunk=4)

    assert torch.autograd.gradgradcheck(f, floats)


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

def _crystals(mod):
    """Two crystals of the JAX tests' kind, a one-atom crystal whose bonds
    are all self-image pairs, and one whose per-center neighbor cap breaks
    pair symmetry (singleton undirected entries)."""
    out = []
    for n, seed in ((7, 27), (9, 29)):
        rng = np.random.default_rng(seed)
        a = (n * 14.0) ** (1 / 3)
        out.append(mod.Crystal(
            lattice=np.eye(3) * a + rng.normal(0, .1, (3, 3)),
            frac_coords=rng.random((n, 3)),
            atomic_numbers=rng.integers(1, 60, n)))
    out.append(mod.Crystal(lattice=np.eye(3) * 2.8,
                           frac_coords=np.zeros((1, 3)),
                           atomic_numbers=np.array([8])))
    rng = np.random.default_rng(7)
    out.append(mod.Crystal(lattice=np.eye(3) * 4.0
                           + rng.normal(0, .05, (3, 3)),
                           frac_coords=rng.random((6, 3)),
                           atomic_numbers=rng.integers(1, 60, 6)))
    return out


def _graphs(mod, crystals):
    gs = [mod.build_graph(c) for c in crystals[:-1]]
    return gs + [mod.build_graph(crystals[-1], max_nbr_per_atom=3,
                                 cap_mode="per_center")]


def _pack(mod, pack, caps_cls, labels=False):
    cs = _crystals(mod)
    if labels:
        rng = np.random.default_rng(11)
        cs = [mod.Crystal(lattice=c.lattice, frac_coords=c.frac_coords,
                          atomic_numbers=c.atomic_numbers,
                          energy=float(rng.normal()),
                          forces=rng.normal(0, .1, (c.num_atoms, 3)),
                          stress=rng.normal(0, .1, (3, 3)),
                          magmoms=np.abs(rng.normal(0, 1, c.num_atoms)))
              for c in cs]
    gs = _graphs(mod, cs)
    und = sum(g.num_undirected for g in gs)
    caps = caps_cls(sum(c.num_atoms for c in cs) + 5,
                    sum(g.num_bonds for g in gs) + 9,
                    sum(g.num_angles for g in gs) + 6, und_bonds=und + 4)
    return pack(cs, gs, caps, num_crystal_slots=5)


@pytest.fixture(scope="module")
def batches():
    return (_pack(jn, j_pack, JCaps, labels=True),
            _pack(tn, t_pack, TCaps, labels=True))


@pytest.fixture(scope="module")
def params():
    jp = j_init(jax.random.PRNGKey(3), JC.FAST_SYM.with_(**SMALL))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def test_batch_has_the_edge_cases(batches):
    """The model batch holds self-image pairs and singleton entries."""
    _, tb = batches
    n_b = int(tb.bond_offsets[-1])
    assert bool((tb.bond_center[:n_b] == tb.bond_nbr[:n_b]).any())
    n_u = int(tb.und_mask.sum())
    assert 2 * n_u > n_b  # singletons: Eu > E/2
    # singletons are the Eu rows with one directed bond
    assert int((tb.bond_sign[:n_b] < 0).sum()) < n_u
    np.testing.assert_array_equal(
        tb.sym_offsets.numpy(), np.asarray(batches[0].sym_offsets))


def test_undirected_geometry_matches_jax(batches):
    jb, tb = batches
    for rows in ("undirected", "directed"):
        want = jbasis.compute_geometry_undirected(jb, angle_rows=rows)
        got = tbasis.compute_geometry_undirected(tb, angle_rows=rows)
        for k, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"{rows} output {k}", **TOL)
    # on the real bonds the directed views equal the directed store's
    # geometry (padded bonds read pair 0, the directed store zeros)
    n_b = int(tb.bond_offsets[-1])
    vec, dist = tbasis.compute_geometry(tb)[:2]
    got = tbasis.compute_geometry_undirected(tb)
    np.testing.assert_allclose(got[2][:n_b].numpy(), vec[:n_b].numpy(),
                               **TOL)
    np.testing.assert_allclose(got[3][:n_b].numpy(), dist[:n_b].numpy(),
                               **TOL)


@pytest.fixture(scope="module")
def jax_out(batches, params):
    """JAX forward and jax.grad of the loss at the two unfused twins."""
    jb, _ = batches
    jp, _ = params
    out = {}
    for twin in ("FAST_HALF", "FAST_SYM"):
        cfg = getattr(JC, twin).with_(**SMALL)

        def loss(p, cfg=cfg):
            pred = j_apply(p, cfg, jb)
            return jl.chgnet_loss(pred, jb, JC.LOSS)[0], pred

        (lv, pred), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
        out[twin] = (pred, lv, g)
    return out


@pytest.mark.parametrize("name", list(TWIN))
def test_forward_matches_jax(batches, params, jax_out, name):
    _, tb = batches
    _, tp = params
    want = jax_out[TWIN[name]][0]
    got = chgnet_apply(tp, getattr(TC, name).with_(**SMALL), tb)
    for k in ("energy", "forces", "stress", "magmom"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("name", list(TWIN))
def test_loss_and_param_grads_match_jax(batches, params, jax_out, name):
    """The loss and every parameter leaf's gradient, through the port's
    recompute backwards (fused) or plain autograd (unfused), against
    jax.grad."""
    _, tb = batches
    _, tp = params
    _, want_loss, want = jax_out[TWIN[name]]
    tp = ttrain.params_on(tp, "cpu")
    loss, _ = ttrain.chgnet_loss_fn(tp, getattr(TC, name).with_(**SMALL),
                                    tb, TC.LOSS)
    got = ttrain.grads_of(loss, tp)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                               **TOL)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    assert len(got) == len(paths)
    for path, g, w in zip(paths, got, jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=path,
                                   **TOL)


def test_fused_half_equals_fused(batches, params):
    """FAST_FUSED_HALF computes FAST_FUSED's function (DESIGN.md §5): the
    same outputs and loss on one batch and one parameter tree."""
    _, tb = batches
    tp = ttrain.params_on(params[1], "cpu")
    outs = [ttrain.chgnet_loss_fn(tp, cfg.with_(**SMALL), tb, TC.LOSS)
            for cfg in (TC.FAST_FUSED_HALF, TC.FAST_FUSED)]
    (l_half, _), (l_dir, _) = outs
    np.testing.assert_allclose(l_half.detach().numpy(),
                               l_dir.detach().numpy(), **TOL)
    got = chgnet_apply(tp, TC.FAST_FUSED_HALF.with_(**SMALL), tb)
    want = chgnet_apply(tp, TC.FAST_FUSED.with_(**SMALL), tb)
    for k in got:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   want[k].detach().numpy(), err_msg=k, **TOL)


def test_undirected_virial_matches_jax(batches):
    """The unfused bond-virial head on the undirected store (outer
    products once per pair, the directed weights summed onto Eu rows)
    against JAX, and equal to the directed store's stress."""
    jb, tb = batches
    cfg = dict(SMALL, bond_store="undirected")
    jp = j_init(jax.random.PRNGKey(5), JC.FAST_VIRIAL.with_(**cfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    want = j_apply(jp, JC.FAST_VIRIAL.with_(**cfg), jb)
    got = chgnet_apply(tp, TC.FAST_VIRIAL.with_(**cfg), tb)
    directed = chgnet_apply(tp, TC.FAST_VIRIAL.with_(**SMALL), tb)
    for k in ("energy", "forces", "stress"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
        np.testing.assert_allclose(got[k].numpy(), directed[k].numpy(),
                                   err_msg=k, **TOL)
    assert np.abs(got["stress"].numpy()).max() > 0


def test_autodiff_readout_on_sym_trunk_matches_jax(batches):
    """REFERENCE on the symmetric trunk (tests/test_sym_features.py:193):
    forces and stress are derivatives through the Eu geometry."""
    jb, tb = batches
    cfg = dict(SMALL, num_blocks=1, bond_store="undirected",
               bond_features="undirected")
    jp = j_init(jax.random.PRNGKey(6), JC.REFERENCE.with_(**cfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    want = jax.jit(lambda p: j_apply(p, JC.REFERENCE.with_(**cfg), jb))(jp)
    got = chgnet_apply(tp, TC.REFERENCE.with_(**cfg), tb)
    for k in ("energy", "forces", "stress"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), err_msg=k, **TOL)
    assert np.abs(got["forces"].detach().numpy()).max() > 0


def _md_crystal(mod, n, seed):
    rng = np.random.default_rng(seed)
    a = (n * 14.0) ** (1 / 3)
    return mod.Crystal(lattice=np.eye(3) * a, frac_coords=rng.random((n, 3)),
                       atomic_numbers=rng.integers(1, 60, n))


def test_serve_predict_and_md_match_jax(params):
    """ServeEngine.predict and three BatchedMD steps at FAST_FUSED_SYM
    against JAX's engine at FAST_SYM (tests/test_sym_features.py:237);
    every Verlet update re-emits the dedup-angle maps the trunk reads."""
    jp, tp = params
    jcfg = JC.FAST_SYM.with_(**SMALL)
    tcfg = TC.FAST_FUSED_SYM.with_(**SMALL)
    sizes = (6, 9)
    want = JServe.for_structures(
        jp, jcfg, [_md_crystal(jn, n, n) for n in sizes]).predict(
        [_md_crystal(jn, n, n) for n in sizes])
    serve = ServeEngine.for_structures(
        tp, tcfg, [_md_crystal(tn, n, n) for n in sizes], device="cpu")
    got = serve.predict([_md_crystal(tn, n, n) for n in sizes])
    for k in ("energy", "stress"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    for k in ("forces", "magmom"):
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
    mk = lambda mod: [_md_crystal(mod, 10, 5), _md_crystal(mod, 13, 6)]
    jmd = JMD(JServe.for_structures(jp, jcfg, mk(jn)), mk(jn))
    tmd = BatchedMD(ServeEngine.for_structures(tp, tcfg, mk(tn),
                                               device="cpu"), mk(tn))
    for _ in range(3):
        want, got = jmd.step(1), tmd.step(1)
        np.testing.assert_allclose(got["energy"], want["energy"], **TOL)
        for g, w in zip(got["forces"], want["forces"]):
            np.testing.assert_allclose(g, w, **TOL)
    for r in tmd.replicas:
        g = r.nlist.update(r.crystal)
        assert g.angle_pair is not None and g.und_angle_rep is not None
        assert 2 * g.und_angle_rep.shape[0] == g.num_angles
        assert 2 * g.num_undirected == g.num_bonds


def test_sym_configs_run_and_only_precision_raises():
    """FAST_FUSED_HALF, FAST_FUSED_SYM and FAST_FUSED_HALF_MIXED build; the
    fused symmetric trunk at a bf16 compute dtype raises (kernels 5 and 6
    have no bf16 path yet)."""
    for cfg in (TC.FAST_FUSED_HALF, TC.FAST_FUSED_SYM, TC.FAST_SYM,
                TC.FAST_FUSED_HALF_MIXED):
        CHGNet(cfg.with_(**SMALL), device="cpu")
    with pytest.raises(NotImplementedError, match="next slice"):
        CHGNet(TC.FAST_FUSED_SYM.with_(precision="mixed"), device="cpu")
