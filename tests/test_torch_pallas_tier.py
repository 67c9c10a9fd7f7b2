"""The unfused tier's kernel wrappers of the port on the CPU (their plain
PyTorch versions) against the JAX package's wrappers (the Pallas kernels
in interpret mode) and jnp oracles: the sorted-segment sum, the GatedMLP,
the RBF and the Fourier basis.  Forward within 1e-5; the gradients of the
port's backwards against ``jax.vjp`` of the JAX wrappers (whose custom
VJPs they mirror), the RBF's with respect to its trainable frequencies
too; and each backward twice differentiable in float64, as the autodiff
readout's training needs.  The CUDA kernels themselves run only on the
card (chip_smoke.py holds them against these plain versions)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _segments(rng, e, s, d, n_real):
    ids = np.sort(rng.integers(0, s, n_real)).astype(np.int32)
    seg = np.zeros(e, np.int32)
    seg[:n_real] = ids
    offs = np.searchsorted(ids, np.arange(s + 1)).astype(np.int32)
    # padded payloads are not zeroed: the tail must be ignored anyway
    return rng.normal(0, 1, (e, d)).astype(np.float32), seg, offs, s


def _mlp(rng, m, d_in, d):
    return (rng.normal(0, 1, (m, d_in)).astype(np.float32),
            rng.normal(0, .2, (d_in, 2 * d)).astype(np.float32),
            rng.normal(0, .1, 2 * d).astype(np.float32),
            rng.uniform(.5, 1.5, 2 * d).astype(np.float32),
            rng.normal(0, .1, 2 * d).astype(np.float32))


def _rbf(rng, n, k, n_zero, high=6.0):
    # bond lengths of the model's domain, from 0.1 A (as
    # test_torch_model.test_bases_match_jax): nearer r = 0 the f32 gradient
    # cancels (cos(f r)/r - sin(f r)/r^2) and the JAX package's own kernel
    # VJP and oracle VJP disagree; plus padded bonds at exactly 0
    dist = rng.uniform(0.1, high, n).astype(np.float32)
    dist[:n_zero] = 0.0
    freqs = (np.arange(1, k + 1) * np.pi).astype(np.float32)
    freqs += rng.normal(0, .05, k).astype(np.float32)  # trained frequencies
    return dist, freqs, 6.0, 8


def _fourier(rng, n, k):
    theta = rng.uniform(0, np.pi, n).astype(np.float32)
    theta[:2] = (0.0, np.pi)[:n]
    return theta, k


def _zero_rows(args, n_mid):
    """The same inputs with ``n_mid`` rows in the middle and the last row
    at exactly 0 (padded bonds or angles amid and after the real ones)."""
    x = args[0].copy()
    mid = len(x) // 2
    x[mid:mid + n_mid] = 0.0
    x[-1] = 0.0
    return (x,) + args[1:]


CASES = {
    # name: (make inputs from an rng, JAX oracle)
    "segment_sum_padded_tail": (
        "fused_segment_sum", lambda r: _segments(r, 200, 37, 16, 170)),
    "segment_sum_no_padding": (
        "fused_segment_sum", lambda r: _segments(r, 64, 9, 8, 64)),
    "segment_sum_all_padded": (
        "fused_segment_sum", lambda r: _segments(r, 40, 5, 8, 0)),
    "segment_sum_d3": (
        "fused_segment_sum", lambda r: _segments(r, 120, 11, 3, 100)),
    "gated_mlp_din12": (
        "fused_gated_mlp_packed", lambda r: _mlp(r, 300, 12, 8)),
    "gated_mlp_din16": (
        "fused_gated_mlp_packed", lambda r: _mlp(r, 37, 16, 4)),
    "rbf_short_k7": ("fused_rbf", lambda r: _rbf(r, 50, 7, 4, high=0.6)),
    "rbf_to_cutoff_k31": ("fused_rbf", lambda r: _rbf(r, 600, 31, 9)),
    "fourier_7": ("fused_fourier", lambda r: _fourier(r, 40, 7)),
    "fourier_31": ("fused_fourier", lambda r: _fourier(r, 530, 31)),
}
# Forward cases at the CUDA kernels' tile edges (ops.basis_plan): row
# counts of 1, 3 and no multiple of 4 (a ragged last tile), zero rows amid
# the real ones, the widest Fourier basis.  Their backward is the same
# recompute as CASES' (no kernel), held there.
TILE_CASES = {
    "tile_rbf_31_n1": ("fused_rbf", lambda r: _rbf(r, 1, 31, 0)),
    "tile_rbf_31_n3": ("fused_rbf", lambda r: _rbf(r, 3, 31, 1)),
    "tile_rbf_31_zero_rows": (
        "fused_rbf", lambda r: _zero_rows(_rbf(r, 203, 31, 0), 5)),
    "tile_fourier_7_n3": ("fused_fourier", lambda r: _fourier(r, 3, 7)),
    "tile_fourier_31_n1": ("fused_fourier", lambda r: _fourier(r, 1, 31)),
    "tile_fourier_127_zero_rows": (
        "fused_fourier", lambda r: _zero_rows(_fourier(r, 203, 127), 5)),
}
ORACLES = {"fused_segment_sum": "sorted_segment_sum_ref",
           "fused_gated_mlp_packed": "gated_mlp_packed_ref",
           "fused_rbf": "fused_rbf_ref", "fused_fourier": "fused_fourier_ref"}


def _inputs(case):
    if case in TILE_CASES:
        name, make = TILE_CASES[case]
        return name, make(np.random.default_rng(
            len(CASES) + sorted(TILE_CASES).index(case)))
    name, make = CASES[case]
    return name, make(np.random.default_rng(sorted(CASES).index(case)))


def _floats(args):
    return [i for i, x in enumerate(args)
            if isinstance(x, np.ndarray) and x.dtype == np.float32]


def _call(fn, args, floats, lib):
    full = [lib(x) if isinstance(x, np.ndarray) else x for x in args]
    for i, f in zip(_floats(args), floats):
        full[i] = f
    return fn(*full)


@pytest.mark.parametrize("case", sorted(CASES) + sorted(TILE_CASES))
def test_forward_matches_jax(case):
    name, args = _inputs(case)
    tops.reset_launch_counts()
    got = _call(getattr(tops, name), args, [], torch.from_numpy).numpy()
    # CPU tensors take the plain version: no kernel launches
    assert not any(tops.launch_counts().values())
    static = [i for i, x in enumerate(args) if not isinstance(x, np.ndarray)]
    want = jax.jit(getattr(jops, name), static_argnums=static)(
        *[jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    oracle = getattr(jref, ORACLES[name])(
        *[jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args])
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


# At the cutoff the RBF's phases reach f_31 * xi ~ 97 rad, where an f32
# phase is good to ~6e-6 rad: the f32 distance gradients of either package
# lie up to 6e-5 from float64 there (measured on this case), and the JAX
# wrapper's VJP and its oracle's VJP differ by as much.  That case holds the
# port to the oracle's VJP at TOL and to the wrapper's at this bound.
WRAPPER_GRAD_TOL = {"rbf_to_cutoff_k31": dict(rtol=1e-5, atol=1e-4)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_jax_vjp(case):
    """Cotangents of every float input (the RBF's frequencies included)
    against ``jax.vjp`` of the JAX wrapper and of its jnp oracle, with the
    default chunk and with a chunk of 7 rows, which divides none of the
    row counts."""
    name, args = _inputs(case)
    idx = _floats(args)
    wants = []
    for fn, tol in ((getattr(jops, name), WRAPPER_GRAD_TOL.get(case, TOL)),
                    (getattr(jref, ORACLES[name]), TOL)):
        out, vjp = jax.vjp(lambda *f: _call(fn, args, f, jnp.asarray),
                           *[jnp.asarray(args[i]) for i in idx])
        cot = np.random.default_rng(1).normal(0, 1, out.shape) \
            .astype(np.float32)
        wants.append((vjp(jnp.asarray(cot)), tol))
    chunks = (None,) if name == "fused_segment_sum" else (None, 7)
    for chunk in chunks:
        kw = {} if chunk is None else {"chunk": chunk}
        floats = [torch.from_numpy(args[i]).requires_grad_() for i in idx]
        got = _call(lambda *a: getattr(tops, name)(*a, **kw), args, floats,
                    torch.from_numpy)
        grads = torch.autograd.grad(got, floats, torch.from_numpy(cot))
        for want, tol in wants:
            for i, g, w in zip(idx, grads, want):
                np.testing.assert_allclose(
                    g.numpy(), np.asarray(w), **tol,
                    err_msg=f"input {i}, chunk {chunk}")


def test_legacy_gated_mlp_packs():
    """The separate-weights calling convention against JAX's."""
    x, w, b, s, o = _mlp(np.random.default_rng(4), 45, 16, 8)
    d = 8
    parts = (w[:, :d], b[:d], w[:, d:], b[d:], s[:d], o[:d], s[d:], o[d:])
    got = tops.fused_gated_mlp(*map(torch.from_numpy, (x,) + parts))
    want = jops.fused_gated_mlp(*map(jnp.asarray, (x,) + parts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rbf_is_zero_on_padded_bonds():
    dist, freqs, r_cut, p = _rbf(np.random.default_rng(2), 20, 31, 5)
    out = tops.fused_rbf(torch.from_numpy(dist), torch.from_numpy(freqs),
                         r_cut, p)
    assert not out[:5].any() and out[5:].abs().sum() > 0


def _umulhi(x, m):
    return (x.astype(np.uint64) * np.uint64(m)) >> np.uint64(32)


@pytest.mark.parametrize("d", [2, 3, 7, 15, 31, 63, 127, 1000, 1024])
def test_multiply_high_divides_exactly(d):
    """``basis.cu``'s row of a flat index: ``__umulhi(x, m)``, m = (2^32 -
    1) // d + 1 (``div_magic``), equals x // d for every index a tile of
    the widest kernel gives (below 2^17)."""
    m = (2**32 - 1) // d + 1
    x = np.arange(1 << 17, dtype=np.uint64)
    assert np.array_equal(_umulhi(x, m), x // d)


def _tile_walk(kind, n, k, plan):
    """Which output element each store of ``basis.cu``'s tile walk writes,
    as flat indices: the RBF's float4 groups (row and column stepped from
    the first) and a ragged tail's scalars; the Fourier basis' column 0,
    its (row, harmonic) pairs into the shared tile (cos at j, sin at L +
    j) and the tile's copy.  Checks the row and column of every element
    against its flat index on the way."""
    t = plan.tile
    hits = np.zeros(n * k, np.int64)
    for tile in range(-(-n // t)):
        row0, rows = tile * t, min(t, n - tile * t)
        count = rows * k
        base = row0 * k
        assert base % 4 == 0  # 16-byte aligned tile start
        if kind == "rbf":
            f = 4 * np.arange(count // 4, dtype=np.uint64)
            r = f.copy() if k == 1 else _umulhi(f, (2**32 - 1) // k + 1)
            j = f - r * np.uint64(k)
            for e in range(4):
                assert np.array_equal(r * np.uint64(k) + j, f + np.uint64(e))
                assert (r < rows).all() and (j < k).all()
                np.add.at(hits, base + (f + np.uint64(e)).astype(np.int64), 1)
                j = j + np.uint64(1)
                wrap = j == k
                j[wrap], r[wrap] = 0, r[wrap] + np.uint64(1)
            tail = np.arange(4 * (count // 4), count)
            np.add.at(hits, base + tail, 1)
        else:
            harm = (k - 1) // 2
            shared = np.zeros(8192, np.int64)
            assert rows * k <= shared.size
            shared[np.arange(rows) * k] += 1
            q = np.arange(rows * harm, dtype=np.uint64)
            r = q if harm <= 1 else _umulhi(q, (2**32 - 1) // harm + 1)
            j = (q - r * np.uint64(harm) + np.uint64(1)).astype(np.int64)
            r = r.astype(np.int64)
            assert (r < rows).all() and ((j >= 1) & (j <= harm)).all()
            np.add.at(shared, r * k + j, 1)
            np.add.at(shared, r * k + harm + j, 1)
            assert (shared[:count] == 1).all() and not shared[count:].any()
            hits[base:base + count] += 1
    return hits


@pytest.mark.parametrize("kind,k", [("rbf", 1), ("rbf", 7), ("rbf", 31),
                                    ("rbf", 127), ("fourier", 1),
                                    ("fourier", 3), ("fourier", 7),
                                    ("fourier", 31), ("fourier", 127)])
def test_basis_tile_walk_writes_every_output_once(kind, k):
    """The CUDA RBF and Fourier kernels' walk over ``ops.basis_plan``'s
    tiles, at the row counts ``chip_smoke.py`` takes to the card (0, 1, 3,
    T - 1, T + 1, 4 T + 3, and more tiles than the grid's blocks): every
    output element is written exactly once; the grid is at most 8 blocks
    an SM and no more than the tiles."""
    t = tops.basis_plan(kind, 1, k, 132).tile
    assert t % 4 == 0 and (kind == "rbf" or t * k <= 8192)
    for n in (0, 1, 3, t - 1, t + 1, 4 * t + 3, 531 * t + 5):
        plan = tops.basis_plan(kind, n, k, 132)
        assert plan.tile == t
        assert 1 <= plan.grid <= max(1, min(-(-n // t), 8 * 132))
        assert (_tile_walk(kind, n, k, plan) == 1).all()


def test_rbf_plan_refuses_more_basis_functions_than_the_kernel_holds():
    """An RBF wider than the kernel's shared frequencies raises before any
    launch (the Fourier basis' bound is ``fused_fourier``'s own check)."""
    assert tops.basis_plan("rbf", 10, 1024, 132).tile == 128
    with pytest.raises(ValueError, match="1024"):
        tops.basis_plan("rbf", 10, 1025, 132)


def test_fourier_rejects_even_bases():
    with pytest.raises(ValueError, match="odd"):
        tops.fused_fourier(torch.zeros(3), 8)
    with pytest.raises(ValueError, match="127"):
        tops.fused_fourier(torch.zeros(3), 129)


DOUBLE = {
    "fused_segment_sum": lambda r: _segments(r, 12, 4, 3, 9),
    "fused_gated_mlp_packed": lambda r: _mlp(r, 5, 6, 3),
    "fused_rbf": lambda r: _rbf(r, 6, 4, 1),
    "fused_fourier": lambda r: _fourier(r, 5, 5),
}


@pytest.mark.parametrize("name", sorted(DOUBLE))
def test_backward_is_twice_differentiable(name):
    """Each backward is built from differentiable torch ops: a float64
    ``gradgradcheck`` through it (chunk 2, so several chunks) passes."""
    args = DOUBLE[name](np.random.default_rng(6))
    if name == "fused_rbf":
        # away from r = 0, where r_safe switches branches
        args = (args[0] + 0.5,) + args[1:]
    idx = _floats(args)
    floats = [torch.from_numpy(args[i]).double().requires_grad_()
              for i in idx]
    kw = {} if name == "fused_segment_sum" else {"chunk": 2}

    def f(*fl):
        return _call(lambda *a: getattr(tops, name)(*a, **kw), args, fl,
                     torch.from_numpy)

    assert torch.autograd.gradgradcheck(f, floats)
