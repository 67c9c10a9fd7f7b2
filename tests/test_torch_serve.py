"""The port's serving engine against the JAX package's on the CPU:
ServeEngine.predict on the crystals of tests/test_serve.py, three
BatchedMD steps, replica independence, and the card as the default
device.  The port runs FAST_FUSED (its kernels' path, here through the
plain versions); the JAX side runs FAST_FS_HEAD, the same function
without the Pallas kernels, which its own tests hold equal to
FAST_FUSED."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import chgnet_mptrj as JC  # noqa: E402
from repro.core import neighbors as jn  # noqa: E402
from repro.core.chgnet import chgnet_init as j_init  # noqa: E402
from repro.serve import BatchedMD as JMD  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import chgnet_mptrj as TC  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import neighbors as tn  # noqa: E402
from repro_torch.serve import BatchedMD, ServeEngine  # noqa: E402

SMALL = dict(dim=16, num_blocks=2, num_rbf=7, num_fourier=7)
JCFG = JC.FAST_FS_HEAD.with_(**SMALL)
TCFG = TC.FAST_FUSED.with_(**SMALL)
TOL = dict(rtol=1e-4, atol=1e-5)


def make_crystal(mod, n, seed=0):
    rng = np.random.default_rng(seed)
    a = (n * 14.0) ** (1 / 3)
    return mod.Crystal(lattice=np.eye(3) * a, frac_coords=rng.random((n, 3)),
                       atomic_numbers=rng.integers(1, 60, n))


@pytest.fixture(scope="module")
def params():
    jp = j_init(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def test_predict_matches_jax(params):
    jp, tp = params
    sizes = (6, 9, 14)
    want = JServe.for_structures(
        jp, JCFG, [make_crystal(jn, n, seed=n) for n in sizes]).predict(
        [make_crystal(jn, n, seed=n) for n in sizes])
    serve = ServeEngine.for_structures(
        tp, TCFG, [make_crystal(tn, n, seed=n) for n in sizes], device="cpu")
    got = serve.predict([make_crystal(tn, n, seed=n) for n in sizes])
    for k in ("energy", "stress"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    for k in ("forces", "magmom"):
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
    assert serve.stats()["batches_packed"] == 1


def test_batched_md_matches_jax(params):
    """Three MD steps of two replicas: the same forces and positions."""
    jp, tp = params
    mk = lambda mod: [make_crystal(mod, 10, seed=5),
                      make_crystal(mod, 13, seed=6)]
    jmd = JMD(JServe.for_structures(jp, JCFG, mk(jn)), mk(jn))
    tmd = BatchedMD(ServeEngine.for_structures(tp, TCFG, mk(tn),
                                               device="cpu"), mk(tn))
    for _ in range(3):
        want, got = jmd.step(1), tmd.step(1)
        np.testing.assert_allclose(got["energy"], want["energy"], **TOL)
        for g, w in zip(got["forces"], want["forces"]):
            np.testing.assert_allclose(g, w, **TOL)
        for rt, rj in zip(tmd.replicas, jmd.replicas):
            np.testing.assert_allclose(rt.crystal.frac_coords,
                                       rj.crystal.frac_coords, **TOL)
    s = tmd.stats()
    assert s["steps_done"] == 3 and s["nlist_updates"] == 6
    assert {"mean_padding_waste", "compile_cache_entries", "nlist_rebuilds",
            "nlist_updates"} <= set(s)


def test_batched_md_replicas_are_independent(params):
    """A replica stepped inside a batch evolves identically to the same
    replica stepped alone (padding/batching leaks nothing)."""
    _, tp = params
    mk = lambda: [make_crystal(tn, 10, seed=5), make_crystal(tn, 13, seed=6)]
    serve = ServeEngine.for_structures(tp, TCFG, mk(), device="cpu")
    out_pair = BatchedMD(serve, mk(), dt=1e-3, skin=0.5).step(5)
    out_solo = BatchedMD(serve, [mk()[0]], dt=1e-3, skin=0.5).step(5)
    np.testing.assert_allclose(
        out_pair["energy"][0], out_solo["energy"][0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        out_pair["forces"][0], out_solo["forces"][0], rtol=1e-3, atol=1e-5)


def test_serve_engine_defaults_to_the_card(params):
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without CUDA")
    _, tp = params
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine.for_structures(tp, TCFG, [make_crystal(tn, 6)])


def test_predict_with_autodiff_readout_matches_jax():
    """ServeEngine.predict at WO_HEAD_PALLAS: forces and stress are
    derivatives of the energy, taken through the unfused tier's wrappers.
    The direct readout serves under inference_mode, whose tensors autograd
    refuses; this one serves under no_grad and must still differentiate."""
    pallas = dict(SMALL, num_blocks=1, mlp_impl="pallas", agg_impl="pallas")
    jcfg = JC.FAST_WO_HEAD.with_(**pallas)
    tcfg = TC.FAST_WO_HEAD.with_(**pallas)
    jp = j_init(jax.random.PRNGKey(2), jcfg)
    sizes = (6, 9)
    want = JServe.for_structures(
        jp, jcfg, [make_crystal(jn, n, seed=n) for n in sizes]).predict(
        [make_crystal(jn, n, seed=n) for n in sizes])
    serve = ServeEngine.for_structures(
        params_from_numpy(jax.tree.map(np.asarray, jp)), tcfg,
        [make_crystal(tn, n, seed=n) for n in sizes], device="cpu")
    got = serve.predict([make_crystal(tn, n, seed=n) for n in sizes])
    for k in ("energy", "stress"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    for k in ("forces", "magmom"):
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
    assert np.abs(np.concatenate(got["forces"])).max() > 0
