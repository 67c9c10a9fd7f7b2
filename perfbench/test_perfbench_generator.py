"""The benchmark's frozen generator and its neighbor lists against the
port's synthetic data and graphs."""
import numpy as np
import pytest

from perfbench import datagen
from perfbench.reference import graph as ref_graph
from repro_torch.data.synthetic import SyntheticConfig, make_dataset

MIX = {"pool": 24, "num_elements": 89, "vol_per_atom": 14.0,
       "sizes": {"lognormal_mu": 2.2, "lognormal_sigma": 0.7,
                 "min_atoms": 2, "max_atoms": 64, "size_seed": None}}


def test_generator_is_the_ports_for_one_seed():
    ds = make_dataset(SyntheticConfig(num_crystals=24, seed=11))
    ours = datagen.make_crystals(MIX, 11, 6.0)
    for c, p, g in zip(ours, ds.crystals, ds.graphs, strict=True):
        assert np.array_equal(c["lattice"], p.lattice)
        assert np.array_equal(c["frac"], p.frac_coords)
        assert np.array_equal(c["z"], p.atomic_numbers)
        # labels: the same sums over the same pairs in another order
        for k, attr in (("energy", "energy"), ("forces", "forces"),
                        ("stress", "stress"), ("magmoms", "magmoms")):
            np.testing.assert_allclose(c[k], getattr(p, attr), rtol=1e-12,
                                       atol=1e-12)
        ref = ref_graph.crystal_graph(c["lattice"], c["frac"], 6.0, 3.0)
        assert sorted(zip(ref["center"], ref["nbr"], map(tuple,
                                                         ref["image"]))) \
            == sorted(zip(g.bond_center, g.bond_nbr, map(tuple,
                                                          g.bond_image)))
        assert len(ref["angle_ij"]) == g.num_angles


def test_fixed_sizes_are_shuffled_by_the_seed():
    mix = dict(MIX, sizes=dict(MIX["sizes"], size_seed=5))
    a = [len(c["z"]) for c in datagen.make_crystals(mix, 1, 6.0)]
    b = [len(c["z"]) for c in datagen.make_crystals(mix, 2, 6.0)]
    assert sorted(a) == sorted(b) and a != b


@pytest.mark.parametrize("part", ["bonds", "angles", "atoms", "labels"])
def test_batch_check_sees_one_changed_entry(part):
    from repro_torch.core.neighbors import Crystal, build_graph
    from repro_torch.batching import BatchCapacities, batch_crystals

    cs = datagen.make_crystals(MIX, 3, 6.0)[:3]
    prog = [Crystal(c["lattice"], c["frac"], c["z"], c["energy"],
                    c["forces"], c["stress"], c["magmoms"]) for c in cs]
    graphs = [build_graph(c, 6.0, 3.0) for c in prog]
    b = batch_crystals(prog, graphs, BatchCapacities(256, 8192, 16384),
                       num_crystal_slots=4).numpy()
    refs = [ref_graph.crystal_graph(c["lattice"], c["frac"], 6.0, 3.0)
            for c in cs]
    ref = ref_graph.concat(cs, refs)
    assert sum(ref_graph.batch_mismatches(b, ref).values()) == 0
    fewer = batch_crystals(prog[:2], graphs[:2], BatchCapacities(
        64, 4096, 8192), num_crystal_slots=4).numpy()
    assert ref_graph.batch_mismatches(fewer, ref)["counts"] > 0
    field = {"bonds": "bond_nbr", "angles": "angle_ik", "atoms": "atom_z",
             "labels": "forces"}[part]
    b[field] = b[field].copy()
    b[field][1] = b[field][1] + 1
    assert ref_graph.batch_mismatches(b, ref)[part] > 0
