"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels (interpret mode on the CPU) and
its jnp oracles, on the sorted-CSR cases of
tests/test_fused_message_passing.py: a padded tail, unaligned rows with no
padding, and every edge padded.  The gradients of the wrappers' recompute
backwards are held against ``jax.vjp`` of the JAX wrappers (whose custom
VJPs recompute the same way) at two chunk sizes.  The CUDA kernels
themselves run only on the card (chip_smoke.py holds them against these
plain versions)."""
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


def _sorted_edges(rng, num_edges, num_segments, n_real):
    ids = np.sort(rng.integers(0, num_segments, n_real)).astype(np.int32)
    seg = np.zeros(num_edges, np.int32)
    seg[:n_real] = ids
    offs = np.searchsorted(ids, np.arange(num_segments + 1)).astype(np.int32)
    return seg, offs


def _mlp(rng, d_in, d):
    return (rng.normal(0, 0.1, (d_in, 2 * d)).astype(np.float32),
            rng.normal(0, 1, 2 * d).astype(np.float32),
            rng.uniform(.5, 1.5, 2 * d).astype(np.float32),
            rng.normal(0, 1, 2 * d).astype(np.float32))


def _f(rng, *shape):
    return rng.normal(0, 1, shape).astype(np.float32)


def atom_inputs(rng, a, e_rows, d, n_real):
    seg, offs = _sorted_edges(rng, e_rows, a, n_real)
    nbr = rng.integers(0, a, e_rows).astype(np.int32)
    return (_f(rng, a, d), _f(rng, e_rows, d), _f(rng, e_rows, d)) \
        + _mlp(rng, 3 * d, d) + (seg, nbr, offs)


def bond_inputs(rng, a, b_rows, e_rows, d, n_real):
    seg, offs = _sorted_edges(rng, e_rows, b_rows, n_real)
    ik = rng.integers(0, b_rows, e_rows).astype(np.int32)
    ctr = rng.integers(0, a, e_rows).astype(np.int32)
    return (_f(rng, a, d), _f(rng, b_rows, d), _f(rng, e_rows, d),
            _f(rng, b_rows, d)) + _mlp(rng, 4 * d, d) + (seg, ik, ctr, offs)


def force_inputs(rng, a, e_rows, d, n_real):
    seg, offs = _sorted_edges(rng, e_rows, a, n_real)
    xh = _f(rng, e_rows, 3)
    xh /= np.linalg.norm(xh, axis=1, keepdims=True)
    return (_f(rng, e_rows, d), xh,
            rng.normal(0, .1, (d, d)).astype(np.float32),
            rng.normal(0, .1, d).astype(np.float32),
            rng.normal(0, .1, (d, 1)).astype(np.float32),
            rng.normal(0, .1, 1).astype(np.float32), seg, offs, a)


def _jax(args):
    return [jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args]


def _torch(args):
    return [torch.from_numpy(x) if isinstance(x, np.ndarray) else x
            for x in args]


def _check(name, args):
    tops.reset_launch_counts()
    got = getattr(tops, name)(*_torch(args)).numpy()
    assert tops.launch_counts() == dict.fromkeys(tops.launch_counts(), 0)
    static = [i for i, x in enumerate(args) if isinstance(x, int)]
    pallas = jax.jit(getattr(jops, name), static_argnums=static)
    np.testing.assert_allclose(got, np.asarray(pallas(*_jax(args))), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(getattr(jref, f"{name}_ref")(*_jax(args))), **TOL)


@pytest.mark.parametrize("a,e_rows,d,n_real", [
    (16, 200, 32, 180),   # padded tail
    (9, 64, 64, 64),      # no padding, unaligned rows
    (8, 32, 16, 0),       # all edges padded
])
def test_atom_conv_matches_jax(a, e_rows, d, n_real):
    rng = np.random.default_rng(a + n_real)
    _check("fused_atom_conv", atom_inputs(rng, a, e_rows, d, n_real))


@pytest.mark.parametrize("a,b_rows,e_rows,d,n_real", [
    (10, 48, 300, 32, 260),
    (6, 17, 40, 16, 40),
    (5, 12, 24, 8, 0),
])
def test_bond_conv_matches_jax(a, b_rows, e_rows, d, n_real):
    rng = np.random.default_rng(b_rows + n_real)
    _check("fused_bond_conv", bond_inputs(rng, a, b_rows, e_rows, d, n_real))


@pytest.mark.parametrize("a,e_rows,d,n_real", [
    (14, 180, 32, 150),
    (9, 64, 16, 64),
    (8, 32, 16, 0),
])
def test_force_readout_matches_jax(a, e_rows, d, n_real):
    rng = np.random.default_rng(a + e_rows + n_real)
    _check("fused_force_readout", force_inputs(rng, a, e_rows, d, n_real))


def test_padded_tail_never_reaches_row_zero():
    """Padded edges carry id 0 and alias row 0: the plain versions mask
    everything past offsets[-1] before their scatter."""
    rng = np.random.default_rng(5)
    args = _torch(atom_inputs(rng, 6, 40, 8, 0))
    assert not tops.fused_atom_conv(*args).any()
    args = _torch(force_inputs(rng, 6, 40, 8, 0))
    assert not tops.fused_force_readout(*args).any()


@pytest.mark.parametrize("name,make", [
    ("fused_atom_conv", lambda r: atom_inputs(r, 6, 40, 8, 30)),
    ("fused_bond_conv", lambda r: bond_inputs(r, 5, 12, 24, 8, 20)),
    ("fused_force_readout", lambda r: force_inputs(r, 6, 40, 8, 30)),
])
def test_wrappers_are_forward_only(name, make):
    """Each wrapper records a gradient for every float input (it is no
    longer forward-only) and its recompute backward matches plain autograd
    through its plain version."""
    rng = np.random.default_rng(0)
    args = _torch(make(rng))
    idx = [i for i, x in enumerate(args)
           if torch.is_tensor(x) and x.is_floating_point()]
    for i in idx:
        args[i] = args[i].requires_grad_()
    out = getattr(tops, name)(*args)
    assert out.grad_fn is not None
    cot = torch.from_numpy(rng.normal(0, 1, out.shape).astype(np.float32))
    got = torch.autograd.grad(out, [args[i] for i in idx], cot)
    want = torch.autograd.grad(getattr(tref, f"{name}_ref")(*args),
                               [args[i] for i in idx], cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def virial_inputs(rng, a, b_crys, e_rows, d, n_real):
    """Inputs of tests/test_virial.py's op tests: random crystal ids."""
    seg, offs = _sorted_edges(rng, e_rows, a, n_real)
    cry = np.zeros(e_rows, np.int32)
    cry[:n_real] = rng.integers(0, b_crys, n_real)
    xh = _f(rng, e_rows, 3)
    xh /= np.linalg.norm(xh, axis=1, keepdims=True)
    return (_f(rng, e_rows, d), xh,
            rng.uniform(0.5, 4.0, e_rows).astype(np.float32),
            rng.normal(0, .1, (d, d)).astype(np.float32),
            rng.normal(0, .1, d).astype(np.float32),
            rng.normal(0, .1, (d, 1)).astype(np.float32),
            rng.normal(0, .1, 1).astype(np.float32), seg, cry, offs, a, b_crys)


GRAD_CASES = {
    "fused_atom_conv": (lambda r, n: atom_inputs(r, 7, 45, 8, n), (40, 0)),
    "fused_bond_conv": (lambda r, n: bond_inputs(r, 6, 13, 45, 8, n),
                        (38, 0)),
    "fused_force_readout": (lambda r, n: force_inputs(r, 7, 45, 8, n),
                            (40, 0)),
    "fused_force_virial_readout": (
        lambda r, n: virial_inputs(r, 7, 3, 45, 8, n), (40, 0)),
}


@pytest.mark.parametrize("name,n_real", [
    (name, n) for name, (_, reals) in GRAD_CASES.items() for n in reals])
def test_wrapper_grads_match_jax_vjp(name, n_real):
    """Cotangents of every float input against ``jax.vjp`` of the JAX
    wrapper, on a padded tail and on an all-padded layout, with one
    backward chunk and with a chunk of 7 edges (which does not divide
    E = 45): the result does not depend on the chunk."""
    rng = np.random.default_rng(n_real + len(name))
    args = GRAD_CASES[name][0](rng, n_real)
    idx = [i for i, x in enumerate(args)
           if isinstance(x, np.ndarray) and x.dtype == np.float32]
    rest = [(i, x) for i, x in enumerate(args) if i not in idx]

    def call(fn, floats, lib):
        full = dict(zip(idx, floats))
        full.update((i, lib(x) if isinstance(x, np.ndarray) else x)
                    for i, x in rest)
        return fn(*[full[i] for i in range(len(args))])

    out, vjp = jax.vjp(lambda *f: call(getattr(jops, name), f, jnp.asarray),
                       *[jnp.asarray(args[i]) for i in idx])
    outs = out if isinstance(out, tuple) else (out,)
    cots = [rng.normal(0, 1, o.shape).astype(np.float32) for o in outs]
    want = vjp(tuple(map(jnp.asarray, cots)) if len(cots) > 1
               else jnp.asarray(cots[0]))
    for chunk in (None, 7):
        floats = [torch.from_numpy(args[i]).requires_grad_() for i in idx]
        got = call(lambda *a: getattr(tops, name)(*a, chunk=chunk), floats,
                   torch.from_numpy)
        got = got if isinstance(got, tuple) else (got,)
        grads = torch.autograd.grad(got, floats,
                                    [torch.from_numpy(c) for c in cots])
        for i, g, w in zip(idx, grads, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"input {i}, chunk {chunk}",
                                       **TOL)


def test_recompute_backward_is_twice_differentiable():
    """The backward is written in differentiable torch ops: a double
    backward through it (what an autodiff readout on top of the fused
    convs needs) matches finite differences in float64."""
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(x).double() if isinstance(x, np.ndarray)
            and x.dtype == np.float32 else
            (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
            for x in atom_inputs(rng, 4, 9, 4, 7)]
    floats = [a.requires_grad_() for a in args[:7]]

    def f(*xs):
        return tops.fused_atom_conv(*xs, *args[7:], chunk=5)

    assert torch.autograd.gradgradcheck(f, floats)
