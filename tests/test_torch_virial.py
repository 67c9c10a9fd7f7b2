"""The port's bond-virial stress tier (DESIGN.md §7) against the JAX
package on the CPU: the force+virial wrapper (its plain version here)
against the Pallas kernel in interpret mode, the FAST_VIRIAL and
FAST_FUSED_VIRIAL forwards, the parameter tree of the tier, the exact
recovery of the synthetic stress labels, and the tier's physics on the
port alone (tests/test_virial.py's checks).  The wrapper's gradients are
held against jax.vjp in tests/test_torch_kernels.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.batching import BatchCapacities as JCaps  # noqa: E402
from repro.batching import batch_crystals as j_pack  # noqa: E402
from repro.configs import chgnet_mptrj as JC  # noqa: E402
from repro.core import neighbors as jn  # noqa: E402
from repro.core.chgnet import chgnet_apply as j_apply  # noqa: E402
from repro.core.chgnet import chgnet_init as j_init  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.batching import BatchCapacities as TCaps  # noqa: E402
from repro_torch.batching import batch_crystals as t_pack  # noqa: E402
from repro_torch.batching import validate_layout  # noqa: E402
from repro_torch.configs import chgnet_mptrj as TC  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import CHGNet, basis, heads, neighbors as tn  # noqa: E402
from repro_torch.core.chgnet import chgnet_apply, chgnet_init  # noqa: E402
from repro_torch.core.graph import CrystalGraphBatch  # noqa: E402
from repro_torch.data import SyntheticConfig, make_dataset  # noqa: E402
from repro_torch.data.synthetic import _morse_dr  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from test_torch_kernels import virial_inputs  # noqa: E402

SMALL = dict(dim=16, num_blocks=2, num_rbf=7, num_fourier=7)
TOL = dict(rtol=1e-4, atol=1e-5)  # the model tests' tolerance


def _row_crystals(rng, layout, a, b_crys):
    """The crystal of each of ``a`` atom rows: contiguous row ranges in a
    permuted slot order, crystals whose rows interleave, or contiguous
    ranges with an empty slot (1) between the others."""
    if layout == "interleaved":
        return rng.integers(0, b_crys, a).astype(np.int32)
    slots = {"permuted": rng.permutation(b_crys),
             "empty-slot": np.array([2, 0, 1 + b_crys // 2])}[layout]
    cuts = np.sort(rng.choice(np.arange(1, a), len(slots) - 1,
                              replace=False))
    return np.repeat(slots, np.diff(np.concatenate([[0], cuts, [a]]))) \
        .astype(np.int32)


_VIRIAL_CASES = [
    (16, 4, 300, 260),   # padded tail
    (9, 3, 64, 64),      # no padding, unaligned rows
    (8, 2, 32, 0),       # all edges padded
    (14, 1, 180, 150),   # single crystal
]


@pytest.mark.parametrize("a,b_crys,e_rows,n_real,layout", [
    # random crystal ids bond by bond (the plain version takes any ids)
    pytest.param(*c, "bonds", id="-".join(map(str, c)))
    for c in _VIRIAL_CASES] + [
    # a row's bonds in its atom's crystal, as kernel 4b needs on the card,
    # crystal slots in any order over the rows
    pytest.param(16, 4, 300, 260, layout, id=layout)
    for layout in ("permuted", "interleaved", "empty-slot")])
def test_force_virial_matches_jax(a, b_crys, e_rows, n_real, layout):
    rng = np.random.default_rng(a + n_real)
    args = virial_inputs(rng, a, b_crys, e_rows, 32, n_real)
    if layout != "bonds":
        seg, cry = args[7], args[8]
        cry[:n_real] = _row_crystals(rng, layout, a, b_crys)[seg[:n_real]]
    tops.reset_launch_counts()
    f_t, s_t = tops.fused_force_virial_readout(
        *[torch.from_numpy(x) if isinstance(x, np.ndarray) else x
          for x in args])
    assert tops.fused_force_virial_readout.launches == 0  # CPU: no kernel
    f_j, s_j = jops.fused_force_virial_readout(
        *[jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args])
    assert s_t.shape == (b_crys, 3, 3) and s_t.dtype == torch.float32
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), s_t.numpy().transpose(0, 2, 1),
                               atol=1e-6)
    if layout == "empty-slot":
        assert not s_t[1].any()


def _crystal(mod, n, seed):
    rng = np.random.default_rng(seed)
    a = (n * 14.0) ** (1 / 3)
    return mod.Crystal(lattice=np.eye(3) * a + rng.normal(0, .1, (3, 3)),
                       frac_coords=rng.random((n, 3)),
                       atomic_numbers=rng.integers(1, 60, n),
                       energy=float(rng.normal()),
                       forces=rng.normal(0, .1, (n, 3)),
                       stress=rng.normal(0, .1, (3, 3)),
                       magmoms=np.abs(rng.normal(0, 1, n)))


def packed_pair(sizes=(7, 9), slots=3):
    """The same crystals packed by both packages (one padded slot)."""
    jcr = [_crystal(jn, n, 20 + n) for n in sizes]
    tcr = [_crystal(tn, n, 20 + n) for n in sizes]
    jg = [jn.build_graph(c) for c in jcr]
    tg = [tn.build_graph(c) for c in tcr]
    caps = (sum(sizes) + 3, sum(g.num_bonds for g in jg) + 7,
            sum(g.num_angles for g in jg) + 5)
    return (j_pack(jcr, jg, JCaps(*caps), num_crystal_slots=slots),
            t_pack(tcr, tg, TCaps(*caps), num_crystal_slots=slots))


def _relabel(batch, perm):
    """``batch`` with crystal slot c renamed ``perm[c]``, the per-crystal
    fields moved with it: a valid layout whose slots are not in atom
    order."""
    h = batch.numpy()
    for k in ("atom_crystal", "bond_crystal", "und_crystal"):
        h[k] = perm[h[k]].astype(np.int32)
    inv = np.argsort(perm)
    for k in ("lattice", "crystal_mask", "energy", "stress",
              "n_atoms_per_crystal"):
        h[k] = h[k][inv]
    return CrystalGraphBatch.from_numpy(h)


def test_validate_layout_takes_permuted_slots():
    """Crystal slots in any order over the atom rows are a valid layout
    (kernel 4b sums a row into its first bond's crystal), and the stress
    of FAST_FUSED_VIRIAL follows the slots."""
    _, tb = packed_pair(sizes=(7, 9, 5), slots=4)
    perm = np.array([2, 0, 3, 1])
    moved = validate_layout(_relabel(tb, perm))
    cfg = TC.FAST_FUSED_VIRIAL.with_(**SMALL)
    params = chgnet_init(0, cfg)
    want = chgnet_apply(params, cfg, tb)["stress"].detach().numpy()
    got = chgnet_apply(params, cfg, moved)["stress"].detach().numpy()
    np.testing.assert_allclose(got[perm], want, **TOL)


def test_validate_layout_refuses_a_row_with_two_crystals():
    """A row whose real bonds carry two crystal ids breaks kernel 4b's
    precondition: the check names it."""
    _, tb = packed_pair()
    h = tb.numpy()
    offs = h["bond_offsets"]
    row = int(np.argmax(np.diff(offs) >= 2))
    h["bond_crystal"][offs[row + 1] - 1] = \
        (h["bond_crystal"][offs[row]] + 1) % tb.num_crystals
    with pytest.raises(ValueError, match="more than one crystal"):
        validate_layout(CrystalGraphBatch.from_numpy(h))


@pytest.mark.parametrize("name", ["FAST_FUSED_VIRIAL", "FAST_VIRIAL"])
def test_virial_forward_matches_jax(name):
    """Both virial tiers against JAX's unfused FAST_VIRIAL, which
    tests/test_virial.py holds equal to the fused tier."""
    jcfg = JC.FAST_VIRIAL.with_(**SMALL)
    tcfg = getattr(TC, name).with_(**SMALL)
    params = j_init(jax.random.PRNGKey(2), jcfg)
    jb, tb = packed_pair()
    want = jax.jit(lambda p, b: j_apply(p, jcfg, b))(params, jb)
    got = chgnet_apply(params_from_numpy(jax.tree.map(np.asarray, params)),
                       tcfg, tb)
    for k in ("energy", "forces", "stress", "magmom"):
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), err_msg=k, **TOL)
    assert not got["stress"][2].any()  # the padded crystal slot


def test_virial_tier_params_round_trip_bitwise():
    """No stress-head parameters under bond_virial, in either package, so
    the JAX tree of FAST_FUSED_VIRIAL crosses the bridge bitwise."""
    jcfg = JC.FAST_FUSED_VIRIAL.with_(**SMALL)
    tcfg = TC.FAST_FUSED_VIRIAL.with_(**SMALL)
    jp = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), jcfg))
    assert "stress_head" not in jp
    assert sorted(chgnet_init(0, tcfg)) == sorted(jp)
    back = params_to_numpy(CHGNet(tcfg, params_from_numpy(jp),
                                  device="cpu"))
    for want, got in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(got, want)


def _silu_inverse(y):
    """x >= -1.27 with x * sigmoid(x) = y, for y >= 0, by bisection."""
    lo, hi = np.full_like(y, -1.27), y + 2.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        below = mid / (1.0 + np.exp(-mid)) < y
        lo, hi = np.where(below, mid, lo), np.where(below, hi, mid)
    return 0.5 * (lo + hi)


def test_exact_virial_recovery_on_synthetic_labels():
    """With n_ij = phi'(d_ij), the raw partials of the force+virial
    wrapper reproduce the analytic stress labels of the port's synthetic
    dataset (tests/test_virial.py::test_exact_virial_recovery_on_synthetic_labels).
    The force head's MLP is set to emit phi'(d) exactly, in float64:
    n = w2 . silu(e W1 + b1) + b2 with W1 = I, e[:, 0] = silu^-1(phi' + c),
    w2 = e_0 and b2 = -c."""
    ds = make_dataset(SyntheticConfig(num_crystals=3, max_atoms=12, seed=0))
    gs = ds.graphs
    caps = TCaps(sum(c.num_atoms for c in ds.crystals) + 4,
                 sum(g.num_bonds for g in gs) + 8,
                 sum(g.num_angles for g in gs) + 8)
    batch = t_pack(ds.crystals, gs, caps)
    vec, dist, _cos, _theta = basis.compute_geometry(batch)
    real = batch.bond_mask.numpy() > 0
    dphi = np.zeros(real.shape)
    dphi[real] = _morse_dr(dist.numpy().astype(np.float64)[real])
    c = 1.0 - min(dphi.min(), 0.0)
    e = torch.zeros(real.shape[0], 4, dtype=torch.float64)
    e[:, 0] = torch.from_numpy(np.where(real, _silu_inverse(dphi + c), 0.0))
    w2 = torch.zeros(4, 1, dtype=torch.float64)
    w2[0, 0] = 1.0
    x_hat = heads.bond_unit_vectors(vec, dist).double()
    _, raw = tops.fused_force_virial_readout(
        e, x_hat, dist.double(), torch.eye(4, dtype=torch.float64),
        torch.zeros(4, dtype=torch.float64), w2,
        torch.tensor([-c], dtype=torch.float64), batch.bond_center,
        batch.bond_crystal, batch.bond_offsets, batch.atom_cap,
        batch.num_crystals)
    sigma = heads._virial_raw_to_gpa(raw, batch).numpy()
    np.testing.assert_allclose(sigma, batch.stress.numpy(), rtol=1e-3,
                               atol=1e-4)


def test_virial_raw_to_gpa_masks_padded_crystals():
    _, tb = packed_pair()
    out = heads._virial_raw_to_gpa(torch.ones(tb.num_crystals, 3, 3), tb)
    mask = tb.crystal_mask.numpy()
    assert np.all(out.numpy()[mask == 0] == 0)
    assert np.isfinite(out.numpy()).all()


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def test_virial_stress_rotates_and_ignores_translation():
    """sigma(R x) = R sigma(x) R^T and a rigid translation leaves it
    unchanged, at FAST_FUSED_VIRIAL on the port alone."""
    rng = np.random.default_rng(0)
    c = _crystal(tn, 6, 3)
    cfg = TC.FAST_FUSED_VIRIAL.with_(**SMALL)
    params = chgnet_init(0, cfg)

    def stress(cr):
        g = tn.build_graph(cr)
        b = t_pack([cr], [g], TCaps(cr.num_atoms + 3, g.num_bonds + 4,
                                    g.num_angles + 4))
        return chgnet_apply(params, cfg, b)["stress"][0].detach().numpy()

    s1 = stress(c)
    rot = _rotation(rng)
    s2 = stress(tn.Crystal(lattice=c.lattice @ rot.T,
                           frac_coords=c.frac_coords,
                           atomic_numbers=c.atomic_numbers))
    np.testing.assert_allclose(s2, rot @ s1 @ rot.T, atol=2e-4)
    s3 = stress(tn.Crystal(lattice=c.lattice,
                           frac_coords=(c.frac_coords + 0.23) % 1.0,
                           atomic_numbers=c.atomic_numbers))
    np.testing.assert_allclose(s3, s1, atol=2e-4)
