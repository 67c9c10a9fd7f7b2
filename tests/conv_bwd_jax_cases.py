"""Operands of the fused atom and bond convs (kernels 2 and 3) in each
operand form, and the JAX package's cotangents of them, for holding the
port's backward on the card to the JAX package's custom VJPs
(``_fused_atom_conv_bwd`` / ``_fused_bond_conv_bwd``) where JAX does not
run.

The operands are made without a random stream: a splitmix64 hash of each
element's index, in integer arithmetic that every numpy computes alike, so
the CPU and the card build the same ones.  The layouts cross a 64-edge
tile with one row, spread the edges over several blocks, leave rows empty
and pad the tail; the bond conv's ``center_ids`` differ within a row.
``conv_bwd_jax.npz`` beside this file holds ``jax.vjp`` of each form
against the output cotangent ``cotangent(form)``; tests/test_torch_conv_bwd.py
holds that file to a fresh ``jax.vjp`` on the CPU, and
tests/test_torch_conv_bwd_cuda.py the kernel to the file.  To write the
file anew::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/conv_bwd_jax_cases.py
"""
from pathlib import Path

import numpy as np

D = 32
FORMS = ("atom", "atom[pair]", "atom[pair+und]", "bond", "bond[pair]")
FILE = Path(__file__).with_name("conv_bwd_jax.npz")

# CSR row lengths and padded tails: one row of more than 64 edges, rows
# that straddle tiles, empty rows
ATOM_LENS, ATOM_TAIL, ATOM_EU = [0, 70, 3, 0, 20, 1, 25, 9, 2], 6, 70
BOND_LENS = [0, 80, 4, 7, 1, 0, 12, 3, 9, 2, 6, 0, 5, 11, 8, 1, 3, 0, 6, 10]
BOND_TAIL, BOND_EU, ATOMS = 5, 12, 9


def _hash(salt: int, n: int) -> np.ndarray:
    """splitmix64 of salt * 2^32 + i, i < n (uint64, wrapping)."""
    x = (np.arange(n, dtype=np.uint64)
         + np.uint64(salt) * np.uint64(1 << 32)
         + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _floats(salt, shape, scale=1.0, shift=0.0) -> np.ndarray:
    """Uniform in [shift - scale, shift + scale), f32."""
    n = int(np.prod(shape))
    u = (_hash(salt, n) >> np.uint64(40)).astype(np.float64) / 2.0 ** 24
    return (shift + scale * (2.0 * u - 1.0)).reshape(shape).astype(np.float32)


def _ints(salt, high, n) -> np.ndarray:
    return (_hash(salt, n) % np.uint64(high)).astype(np.int32)


def _csr(lens, tail):
    n_real = sum(lens)
    seg = np.zeros(n_real + tail, np.int32)
    seg[:n_real] = np.repeat(np.arange(len(lens)), lens)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return seg, offs


def _mlp(salt, d_in):
    return (_floats(salt, (d_in, 2 * D), 0.17),
            _floats(salt + 1, (2 * D,), 1.0),
            _floats(salt + 2, (2 * D,), 0.5, 1.0),
            _floats(salt + 3, (2 * D,), 1.0))


def case(form: str):
    """(kind, float operands, int operands, keyword arguments) of a form,
    as numpy arrays, in the wrappers' argument order."""
    if form.startswith("atom"):
        seg, offs = _csr(ATOM_LENS, ATOM_TAIL)
        n_edges, rows = seg.shape[0], len(ATOM_LENS)
        und, mirror = form == "atom[pair+und]", form != "atom"
        floats = (_floats(1, (rows, D)),
                  _floats(2, (ATOM_EU if und else n_edges, D)),
                  _floats(3, (ATOM_EU if mirror else n_edges, D)),
                  *_mlp(10, 3 * D))
        ints = (seg, _ints(4, rows, n_edges), offs)
        kw = ({"pair": _ints(5, ATOM_EU, n_edges), "und_features": und}
              if mirror else {})
        return "atom", floats, ints, kw
    seg, offs = _csr(BOND_LENS, BOND_TAIL)
    n_ang, rows = seg.shape[0], len(BOND_LENS)
    mirror = form == "bond[pair]"
    floats = (_floats(21, (ATOMS, D)), _floats(22, (rows, D)),
              _floats(23, (n_ang, D)),
              _floats(24, (BOND_EU if mirror else rows, D)),
              *_mlp(30, 4 * D))
    ints = (seg, _ints(25, rows, n_ang), _ints(26, ATOMS, n_ang), offs)
    kw = {"pair": _ints(27, BOND_EU, rows)} if mirror else {}
    return "bond", floats, ints, kw


def cotangent(form: str) -> np.ndarray:
    """The output's cotangent of a form: (rows, D)."""
    rows = len(ATOM_LENS if form.startswith("atom") else BOND_LENS)
    return _floats(40 + FORMS.index(form), (rows, D))


def jax_cotangents(form: str) -> list:
    """``jax.vjp`` of the JAX package's wrapper of a form at its operands
    and output cotangent: the cotangent of each float operand."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    kind, floats, ints, kw = case(form)
    fn = jops.fused_atom_conv if kind == "atom" else jops.fused_bond_conv
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    _, vjp = jax.vjp(lambda *f: fn(*f, *map(jnp.asarray, ints), **kw),
                     *map(jnp.asarray, floats))
    return [np.asarray(g) for g in vjp(jnp.asarray(cotangent(form)))]


def load() -> dict:
    """The stored cotangents: form -> list of arrays."""
    with np.load(FILE) as z:
        return {f: [z[f"{f}/{i}"] for i in range(len(case(f)[1]))]
                for f in FORMS}


if __name__ == "__main__":
    np.savez_compressed(FILE, **{f"{f}/{i}": g for f in FORMS
                                 for i, g in enumerate(jax_cotangents(f))})
    print(f"wrote {FILE} ({FILE.stat().st_size} bytes)")
