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
    theta[:2] = (0.0, np.pi)
    return theta, k


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
ORACLES = {"fused_segment_sum": "sorted_segment_sum_ref",
           "fused_gated_mlp_packed": "gated_mlp_packed_ref",
           "fused_rbf": "fused_rbf_ref", "fused_fourier": "fused_fourier_ref"}


def _inputs(case):
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


@pytest.mark.parametrize("case", sorted(CASES))
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
