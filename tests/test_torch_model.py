"""The port's model against the JAX package on the CPU: the bases, the
forward (narrowed) at FAST_FUSED and FAST_FS_HEAD, at the unfused Pallas
tier and its neighbours, and with the autodiff readout at REFERENCE and
WO_HEAD_PALLAS; the configs; the finite-difference force check of
test_chgnet.py and the rotation/translation checks of test_equivariance.py
on the port alone."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.batching import BatchCapacities as JCaps  # noqa: E402
from repro.batching import batch_crystals as j_pack  # noqa: E402
from repro.configs import chgnet_mptrj as JC  # noqa: E402
from repro.core import basis as jbasis  # noqa: E402
from repro.core import neighbors as jn  # noqa: E402
from repro.core.chgnet import CHGNetConfig as JConfig  # noqa: E402
from repro.core.chgnet import chgnet_apply as j_apply  # noqa: E402
from repro.core.chgnet import chgnet_init as j_init  # noqa: E402
from repro_torch.batching import BatchCapacities as TCaps  # noqa: E402
from repro_torch.batching import batch_crystals as t_pack  # noqa: E402
from repro_torch.configs import chgnet_mptrj as TC  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import CHGNet, basis as tbasis, neighbors as tn  # noqa: E402
from repro_torch.core.chgnet import CHGNetConfig, chgnet_apply, chgnet_init  # noqa: E402

SMALL = dict(dim=16, num_blocks=2, num_rbf=7, num_fourier=7)
TOL = dict(rtol=1e-4, atol=1e-5)  # the tolerance of tests/test_serve.py


def _crystal(mod, n, seed):
    rng = np.random.default_rng(seed)
    a = (n * 14.0) ** (1 / 3)
    return mod.Crystal(lattice=np.eye(3) * a + rng.normal(0, .1, (3, 3)),
                       frac_coords=rng.random((n, 3)),
                       atomic_numbers=rng.integers(1, 60, n))


def test_bases_match_jax():
    """Envelopes, smooth RBF and Fourier basis against JAX and against a
    float64 numpy evaluation of the same formulas, on bond lengths of the
    model's domain (0.1 A to the 6 A cutoff) plus padded zeros."""
    rng = np.random.default_rng(0)
    r = rng.uniform(0.1, 6.0, 200).astype(np.float32)
    r[:3] = 0.0  # padded entries: the r_safe guard
    theta = rng.uniform(0, np.pi, 100).astype(np.float32)
    xi = r / 6.0
    for name in ("envelope_reference", "envelope_factored"):
        np.testing.assert_allclose(
            getattr(tbasis, name)(torch.from_numpy(xi)).numpy(),
            np.asarray(getattr(jbasis, name)(jnp.asarray(xi))), **TOL)
    freqs = np.array(jbasis.rbf_frequencies(31))
    np.testing.assert_array_equal(tbasis.rbf_frequencies(31).numpy(), freqs)
    x64 = r.astype(np.float64) / 6.0
    u64 = 1.0 - 0.5 * x64**8 * (90.0 + x64 * (-160.0 + 72.0 * x64))
    r_safe = np.where(r > 1e-8, r.astype(np.float64), 1.0)
    rbf64 = np.sqrt(2.0 / 6.0) * np.sin(x64[:, None] * freqs) \
        / r_safe[:, None] * u64[:, None]
    got = tbasis.smooth_rbf(torch.from_numpy(r), torch.from_numpy(freqs),
                            6.0).numpy()
    want = np.asarray(jbasis.smooth_rbf(jnp.asarray(r), jnp.asarray(freqs),
                                        6.0))
    np.testing.assert_allclose(want, rbf64, err_msg="JAX vs float64", **TOL)
    np.testing.assert_allclose(got, rbf64, err_msg="port vs float64", **TOL)
    np.testing.assert_allclose(got, want, err_msg="port vs JAX", **TOL)
    np.testing.assert_allclose(
        tbasis.fourier_basis(torch.from_numpy(theta), 31).numpy(),
        np.asarray(jbasis.fourier_basis(jnp.asarray(theta), 31)), **TOL)


# tiers that are no named config of the package: labels of the tests and
# chip_smoke.py only
TIERS = {
    "FAST_PALLAS": lambda m: m.FAST_FS_HEAD.with_(mlp_impl="pallas",
                                                  agg_impl="pallas"),
    "FS_HEAD_MATMUL": lambda m: m.FAST_FS_HEAD.with_(agg_impl="matmul"),
    "FUSED_MLP_PALLAS": lambda m: m.FAST_FUSED.with_(mlp_impl="pallas"),
    "WO_HEAD_PALLAS": lambda m: m.FAST_WO_HEAD.with_(mlp_impl="pallas",
                                                     agg_impl="pallas"),
}
# the autodiff readout differentiates through the trunk: one block keeps
# the JAX side's compile short
AUTODIFF_SMALL = dict(SMALL, num_blocks=1)


def _config(mod, name):
    cfg = TIERS[name](mod) if name in TIERS else getattr(mod, name)
    return cfg.with_(**(AUTODIFF_SMALL if cfg.readout == "autodiff"
                        else SMALL))


@pytest.mark.parametrize("name", ["FAST_FUSED", "FAST_FS_HEAD", "FAST_PALLAS",
                                  "FS_HEAD_MATMUL", "FUSED_MLP_PALLAS",
                                  "REFERENCE", "WO_HEAD_PALLAS"])
def test_forward_matches_jax(name):
    """Energy, forces, stress and magmom against the JAX package's forward
    (its Pallas kernels in interpret mode); at REFERENCE and WO_HEAD_PALLAS
    forces and stress are derivatives of the energy."""
    jcfg = _config(JC, name)
    tcfg = _config(TC, name)
    params = j_init(jax.random.PRNGKey(1), jcfg)
    jcr = [_crystal(jn, n, 20 + n) for n in (7, 9)]
    tcr = [_crystal(tn, n, 20 + n) for n in (7, 9)]
    jg = [jn.build_graph(c) for c in jcr]
    tg = [tn.build_graph(c) for c in tcr]
    caps = (19, sum(g.num_bonds for g in jg) + 7,
            sum(g.num_angles for g in jg) + 5)
    want = jax.jit(lambda p, b: j_apply(p, jcfg, b))(
        params, j_pack(jcr, jg, JCaps(*caps), num_crystal_slots=3))
    got = chgnet_apply(params_from_numpy(jax.tree.map(np.asarray, params)),
                       tcfg, t_pack(tcr, tg, TCaps(*caps),
                                    num_crystal_slots=3))
    for k in ("energy", "forces", "stress", "magmom"):
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_every_config_is_mirrored():
    def configs(mod, cls):
        return {k: dataclasses.asdict(v) for k, v in vars(mod).items()
                if isinstance(v, cls)}

    assert configs(TC, CHGNetConfig) == configs(JC, JConfig)
    assert dataclasses.asdict(TC.LOSS) == dataclasses.asdict(JC.LOSS)
    assert [f.name for f in dataclasses.fields(CHGNetConfig)] == \
        [f.name for f in dataclasses.fields(JConfig)]
    with pytest.raises(ValueError, match="undirected bond store"):
        CHGNetConfig(bond_features="undirected")


def test_pallas_aggregation_needs_offsets():
    from repro_torch.core.interaction import segment_aggregate

    with pytest.raises(ValueError, match="offsets"):
        segment_aggregate(torch.ones(4, 2), torch.zeros(4, dtype=torch.int32),
                          3, torch.ones(4), "pallas")


@pytest.mark.parametrize("name", ["REFERENCE", "WO_HEAD_PALLAS"])
def test_autodiff_force_matches_finite_difference(name):
    """tests/test_chgnet.py's check on the port alone: F = -dE/dx against
    centered finite differences of the energy, through the plain ops
    (REFERENCE) and through the unfused tier's kernel wrappers, whose
    backwards give the derivative (WO_HEAD_PALLAS)."""
    rng = np.random.default_rng(7)
    c = tn.Crystal(lattice=np.eye(3) * 4.5, frac_coords=rng.random((4, 3)),
                   atomic_numbers=rng.integers(1, 20, 4))
    g = tn.build_graph(c)
    caps = TCaps(8, g.num_bonds + 4, g.num_angles + 4)
    cfg = _config(TC, name)
    model = CHGNet(cfg, seed=0, device="cpu")

    def energy_at(cart_shift):
        c2 = tn.Crystal(lattice=c.lattice,
                        frac_coords=(c.cart_coords() + cart_shift)
                        @ np.linalg.inv(c.lattice),
                        atomic_numbers=c.atomic_numbers)
        with torch.no_grad():  # same topology, moved atoms
            return float(model(t_pack([c2], [g], caps))["energy"][0])

    with torch.no_grad():
        forces = model(t_pack([c], [g], caps))["forces"].numpy()
    eps = 1e-3
    for (i, k) in [(0, 0), (1, 2), (3, 1)]:
        dx = np.zeros((4, 3))
        dx[i, k] = eps
        f_num = -(energy_at(dx) - energy_at(-dx)) / (2 * eps)
        assert abs(f_num - forces[i, k]) < 5e-3 * max(1, abs(f_num)) + 1e-3


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CHGNet(TC.FAST_FUSED.with_(**SMALL))


# ---------------------------------------------------------------------------
# physics checks of tests/test_equivariance.py, on the port alone
# ---------------------------------------------------------------------------

def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def _apply(model, c):
    g = tn.build_graph(c)
    caps = TCaps(8, g.num_bonds + 4, g.num_angles + 4)
    with torch.inference_mode():
        return model(t_pack([c], [g], caps)), g


@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_equivariance(seed):
    """F(R x) = R F(x) (Eq. 8) and E(R x) = E(x)."""
    rng = np.random.default_rng(seed)
    c = tn.Crystal(lattice=np.eye(3) * 4.4 + rng.normal(0, .05, (3, 3)),
                   frac_coords=rng.random((5, 3)),
                   atomic_numbers=rng.integers(1, 60, 5))
    rot = _rotation(rng)
    model = CHGNet(TC.FAST_FUSED.with_(**SMALL), seed=seed, device="cpu")
    out1, g1 = _apply(model, c)
    out2, g2 = _apply(model, tn.Crystal(lattice=c.lattice @ rot.T,
                                        frac_coords=c.frac_coords,
                                        atomic_numbers=c.atomic_numbers))
    assert g2.num_bonds == g1.num_bonds
    f1, f2 = out1["forces"].numpy()[:5], out2["forces"].numpy()[:5]
    np.testing.assert_allclose(f2, f1 @ rot.T, atol=2e-4)
    np.testing.assert_allclose(out2["energy"].numpy(), out1["energy"].numpy(),
                               atol=2e-4)


def test_translation_invariance():
    """A rigid translation (with periodic wrap) relabels bond images but
    leaves energy and per-atom forces alone."""
    rng = np.random.default_rng(8)
    c = tn.Crystal(lattice=np.eye(3) * 4.4 + rng.normal(0, .05, (3, 3)),
                   frac_coords=rng.random((5, 3)),
                   atomic_numbers=rng.integers(1, 60, 5))
    model = CHGNet(TC.FAST_FUSED.with_(**SMALL), seed=3, device="cpu")
    out1, g1 = _apply(model, c)
    out2, g2 = _apply(model, tn.Crystal(
        lattice=c.lattice, frac_coords=(c.frac_coords + rng.random(3)) % 1.0,
        atomic_numbers=c.atomic_numbers))
    assert g2.num_bonds == g1.num_bonds
    np.testing.assert_allclose(out2["energy"].numpy(), out1["energy"].numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(out2["forces"].numpy()[:5],
                               out1["forces"].numpy()[:5], atol=2e-4)


def test_init_is_seeded():
    a = chgnet_init(7, TC.FAST_FUSED.with_(**SMALL))
    b = chgnet_init(torch.Generator().manual_seed(7),
                    TC.FAST_FUSED.with_(**SMALL))
    assert torch.equal(a["blocks"][1]["bond_mlp"]["w"],
                       b["blocks"][1]["bond_mlp"]["w"])
    assert a["blocks"][0]["atom_mlp"]["w"].shape == (48, 32)
