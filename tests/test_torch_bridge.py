"""The port's host side and weight bridge against the JAX package: the
parameter round trip is bitwise, the neighbor graphs (one-shot and
Verlet-skin) are equal field for field, and packed batches are bitwise
equal in all 35 fields."""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.batching import BatchCapacities as JCaps  # noqa: E402
from repro.batching import batch_crystals as j_pack  # noqa: E402
from repro.configs import chgnet_mptrj as JC  # noqa: E402
from repro.core.chgnet import chgnet_init as j_init  # noqa: E402
from repro.core.graph import CrystalGraphBatch as JBatch  # noqa: E402
from repro.core import neighbors as jn  # noqa: E402
from repro_torch.batching import BatchCapacities as TCaps  # noqa: E402
from repro_torch.batching import batch_crystals as t_pack  # noqa: E402
from repro_torch.batching import padding_waste, validate_layout  # noqa: E402
from repro_torch.configs import chgnet_mptrj as TC  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import CHGNet, graph as tgraph, neighbors as tn  # noqa: E402

SMALL = dict(dim=16, num_blocks=2, num_rbf=7, num_fourier=7)


def _crystal(mod, n, seed, jitter=0.1):
    rng = np.random.default_rng(seed)
    a = (n * 14.0) ** (1 / 3)
    return mod.Crystal(lattice=np.eye(3) * a + rng.normal(0, jitter, (3, 3)),
                       frac_coords=rng.random((n, 3)),
                       atomic_numbers=rng.integers(1, 60, n))


def _assert_tree_bitwise(got, want, path="params"):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_bitwise(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_bitwise(g, w, f"{path}.{i}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path


def _assert_graphs_equal(tg, jg):
    for f in dataclasses.fields(jg):
        want, got = getattr(jg, f.name), getattr(tg, f.name)
        assert got.dtype == want.dtype, f.name
        assert np.array_equal(got, want), f.name


@pytest.mark.parametrize("name", ["FAST_FUSED", "FAST_FS_HEAD"])
def test_params_round_trip_is_bitwise(name):
    cfg = getattr(JC, name).with_(**SMALL)
    jtree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(3), cfg))
    model = CHGNet(getattr(TC, name).with_(**SMALL),
                   params_from_numpy(jtree), device="cpu")
    _assert_tree_bitwise(params_to_numpy(model), jtree)
    # the module's parameter names are the tree's paths
    names = {n for n, _ in model.named_parameters()}
    assert {"atom_embed", "blocks.1.atom_mlp.w", "final_block.bond_mlp.w",
            "force_head.mlp.1.b", "stress_head.scale"} <= names


@pytest.mark.parametrize("n,seed", [(5, 0), (11, 1)])
def test_build_graph_matches_jax(n, seed):
    _assert_graphs_equal(tn.build_graph(_crystal(tn, n, seed)),
                         jn.build_graph(_crystal(jn, n, seed)))


def test_verlet_updates_match_jax_over_toy_md():
    """Five toy MD steps, one of them crossing the skin/2 rebuild trigger
    and one wrapping an atom across the cell boundary."""
    tc, jc = _crystal(tn, 12, 4), _crystal(jn, 12, 4)
    t_nl = tn.VerletNeighborList(tc, skin=0.5)
    j_nl = jn.VerletNeighborList(jc, skin=0.5)
    rng = np.random.default_rng(9)
    for step in range(5):
        scale = 0.3 if step == 3 else 0.02
        frac = (tc.frac_coords + rng.normal(0, scale / 5.0, (12, 3))) % 1.0
        tc.frac_coords = frac
        jc.frac_coords = frac.copy()
        _assert_graphs_equal(t_nl.update(tc), j_nl.update(jc))
    assert (t_nl.rebuilds, t_nl.updates) == (j_nl.rebuilds, j_nl.updates)
    assert t_nl.rebuilds >= 2


def test_batch_crystals_bitwise_in_all_fields():
    sizes = (5, 8, 3)
    tcr = [_crystal(tn, n, 10 + n) for n in sizes]
    jcr = [_crystal(jn, n, 10 + n) for n in sizes]
    for c in tcr:  # labels pack too
        c.energy, c.forces = 1.5, np.ones((c.num_atoms, 3))
        c.stress, c.magmoms = np.eye(3), np.full(c.num_atoms, 0.25)
    for c, t in zip(jcr, tcr):
        c.energy, c.forces, c.stress, c.magmoms = copy.deepcopy(
            (t.energy, t.forces, t.stress, t.magmoms))
    tg = [tn.build_graph(c) for c in tcr]
    jg = [jn.build_graph(c) for c in jcr]
    caps = (sum(sizes) + 5, sum(g.num_bonds for g in jg) + 9,
            sum(g.num_angles for g in jg) + 6)
    tb = t_pack(tcr, tg, TCaps(*caps), num_crystal_slots=4)
    jb = j_pack(jcr, jg, JCaps(*caps), num_crystal_slots=4)
    names = [f.name for f in dataclasses.fields(JBatch)]
    assert len(names) == 35 and tuple(names) == tgraph.FIELDS
    for k in names:
        want, got = np.asarray(getattr(jb, k)), getattr(tb, k).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert np.array_equal(got, want), k
    assert (tb.atom_cap, tb.bond_cap, tb.angle_cap, tb.und_cap,
            tb.und_angle_cap, tb.num_crystals) == (
        jb.atom_cap, jb.bond_cap, jb.angle_cap, jb.und_cap,
        jb.und_angle_cap, jb.num_crystals)
    validate_layout(tb)
    assert padding_waste(tb) == pytest.approx(
        float(1 - (sum(sizes) + caps[1] - 9 + caps[2] - 6) / sum(caps)))


def test_batch_moves_between_devices_whole():
    c = _crystal(tn, 6, 2)
    g = tn.build_graph(c)
    b = t_pack([c], [g], TCaps(8, g.num_bonds + 4, g.num_angles + 4))
    moved = b.to("cpu")
    assert moved.atom_z.device == torch.device("cpu")
    for k in tgraph.FIELDS:
        assert torch.equal(getattr(moved, k), getattr(b, k)), k
    assert b.bond_center.dtype == torch.int32
