"""Which backward the fused convs (kernels 2 and 3) take, on the CPU.

On the card a first-order backward of ``fused_atom_conv`` /
``fused_bond_conv`` is a kernel (``conv_bwd_kernel``); with grad mode on
inside the backward (a double backward) and on the CPU it is the chunked
recompute.  The kernel itself runs only on the card:
tests/test_torch_conv_bwd_cuda.py holds it to the recompute there, and to
the JAX package's cotangents stored in tests/conv_bwd_jax.npz.  Here: the
choice, the counters, the launch plan, and that stored file against the
JAX package and the recompute."""
import types

import numpy as np
import pytest
import torch

import conv_bwd_jax_cases as jax_cases
from repro_torch.kernels import ops

ATOM, BOND = ops.fused_atom_conv, ops.fused_bond_conv


def _f(rng, *shape):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))


def _csr(rng, n_edges, rows, n_real):
    ids = np.sort(rng.integers(0, rows, n_real)).astype(np.int32)
    seg = np.zeros(n_edges, np.int32)
    seg[:n_real] = ids
    offs = np.searchsorted(ids, np.arange(rows + 1)).astype(np.int32)
    return torch.from_numpy(seg), torch.from_numpy(offs)


def _mlp(rng, d_in, d):
    return (_f(rng, d_in, 2 * d) * 0.1, _f(rng, 2 * d),
            _f(rng, 2 * d) * 0.2 + 1.0, _f(rng, 2 * d))


def _ids(rng, high, n):
    return torch.from_numpy(rng.integers(0, high, n).astype(np.int32))


def _inputs(name, rng, d=8):
    """A small conv call: (wrapper, float operands, the rest, kwargs)."""
    if name.startswith("atom"):
        seg, offs = _csr(rng, 40, 6, 31)
        pair = _ids(rng, 22, 40)
        und = name == "atom[pair+und]"
        e_rows = 22 if und else 40
        ea_rows = 40 if name == "atom" else 22
        floats = [_f(rng, 6, d), _f(rng, e_rows, d), _f(rng, ea_rows, d),
                  *_mlp(rng, 3 * d, d)]
        kw = {} if name == "atom" else {"pair": pair, "und_features": und}
        return ATOM, floats, [seg, _ids(rng, 6, 40), offs], kw
    seg, offs = _csr(rng, 30, 9, 25)
    pair = _ids(rng, 5, 9)
    floats = [_f(rng, 4, d), _f(rng, 9, d), _f(rng, 30, d),
              _f(rng, 9 if name == "bond" else 5, d), *_mlp(rng, 4 * d, d)]
    rest = [seg, _ids(rng, 9, 30), _ids(rng, 4, 30), offs]
    return BOND, floats, rest, {} if name == "bond" else {"pair": pair}


FORMS = ("atom", "atom[pair]", "atom[pair+und]", "bond", "bond[pair]")


@pytest.fixture
def spies(monkeypatch):
    """Record each call of ``_recompute_vjp`` and, for each call of the
    kernel's test ``_bwd_kernel``, whether grad mode was on."""
    calls = {"recompute": 0, "grad_mode": []}
    recompute, choose = ops._recompute_vjp, ops._bwd_kernel

    def spy_recompute(*a, **kw):
        calls["recompute"] += 1
        return recompute(*a, **kw)

    def spy_choose(g):
        calls["grad_mode"].append(torch.is_grad_enabled())
        return choose(g)

    monkeypatch.setattr(ops, "_recompute_vjp", spy_recompute)
    monkeypatch.setattr(ops, "_bwd_kernel", spy_choose)
    ops.reset_launch_counts()
    yield calls
    ops.reset_launch_counts()


@pytest.mark.parametrize("name", FORMS)
def test_cpu_backward_recomputes(name, spies):
    """On the CPU each backward is the recompute: one call a backward,
    the kernel's counters and C entries untouched."""
    rng = np.random.default_rng(len(name))
    fn, floats, rest, kw = _inputs(name, rng)
    floats = [t.requires_grad_() for t in floats]
    out = fn(*floats, *rest, **kw)
    grads = torch.autograd.grad(out, floats, torch.ones_like(out))
    assert all(torch.isfinite(g).all() for g in grads)
    assert spies["recompute"] == 1
    assert spies["grad_mode"] == [False]
    assert ATOM.bwd_launches == BOND.bwd_launches == 0
    assert ops.entry_launch_counts() == {}


@pytest.mark.parametrize("name", ("atom[pair]", "bond"))
def test_double_backward_recomputes_with_grad_mode_on(name, spies):
    """A backward taken with ``create_graph`` (the autodiff readout's
    forces) runs with grad mode on, so it recomputes on any device, and
    its cotangents can be differentiated again.  Differentiating them
    reaches the conv's own node once more, through the cotangent 2 out,
    as a first-order backward (grad mode off: on the card, the kernel)."""
    rng = np.random.default_rng(7)
    fn, floats, rest, kw = _inputs(name, rng)
    floats = [t.requires_grad_() for t in floats]
    out = fn(*floats, *rest, **kw)
    first = torch.autograd.grad((out * out).sum(), floats, create_graph=True)
    assert spies["grad_mode"] == [True]
    second = torch.autograd.grad(sum(g.sum() for g in first), floats,
                                 allow_unused=True)
    assert any(g is not None and g.abs().sum() > 0 for g in second)
    assert spies["grad_mode"] == [True, False]
    assert spies["recompute"] == 2
    assert ATOM.bwd_launches == BOND.bwd_launches == 0


@pytest.mark.parametrize("is_cuda,grad_mode,deterministic,want", [
    (True, False, False, True),     # first order on the card: the kernel
    (True, True, False, False),     # a double backward's first backward
    (True, False, True, True),      # run-to-run equal bits asked for: the
                                    # kernel gives them
    (False, False, False, False),   # the CPU
])
def test_kernel_choice(is_cuda, grad_mode, deterministic, want):
    """The kernel runs where what the wrapper observes allows it: the
    cotangent on the card and grad mode off; PyTorch's deterministic
    algorithms do not turn it off (its sums have a fixed order)."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(deterministic)
    try:
        with torch.set_grad_enabled(grad_mode):
            got = ops._bwd_kernel(types.SimpleNamespace(is_cuda=is_cuda))
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
    assert got is want


# each stored cotangent within this share of its largest element (the
# limit of tests/test_torch_conv_bwd_cuda.py)
F32_REL = 1e-4


def _close(got, want, label):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (label, i)
        scale = float(np.abs(w).max()) if w.size else 0.0
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= F32_REL * scale, f"{label}: cotangent {i}: {err} " \
            f"(largest {scale})"


@pytest.mark.parametrize("form", jax_cases.FORMS)
def test_recompute_matches_stored_jax_cotangents(form):
    """The stored JAX cotangents, which the card's kernel is held to,
    against the port's backward on the CPU (the recompute, itself held to
    ``jax.vjp`` in tests/test_torch_kernels.py): the same operands and
    cotangent, at the stated limit."""
    kind, floats, ints, kw = jax_cases.case(form)
    fn = ATOM if kind == "atom" else BOND
    floats = [torch.from_numpy(x).requires_grad_() for x in floats]
    kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    out = fn(*floats, *map(torch.from_numpy, ints), **kw)
    got = torch.autograd.grad(out, floats,
                              torch.from_numpy(jax_cases.cotangent(form)))
    _close([g.numpy() for g in got], jax_cases.load()[form], form)


def test_stored_cotangents_are_jax_vjp():
    """The stored file is what ``jax.vjp`` of the JAX package's wrapper
    gives now, on the bond conv through ``pair`` (each other form takes
    seconds more, and the recompute test above holds them)."""
    _close(jax_cases.jax_cotangents("bond[pair]"),
           jax_cases.load()["bond[pair]"], "bond[pair]")


@pytest.mark.parametrize("mode", ("atom", "bond"))
@pytest.mark.parametrize("dim", ops.CONV_WIDTHS)
def test_conv_bwd_plan_fits_the_card(mode, dim):
    """The backward kernel's plan: 64-edge tiles, its shared memory within
    a block's 232,448 bytes and the SM's, two blocks a SM up to D = 64, a
    grid of those blocks on 132 SMs and no more blocks than rows."""
    plan = ops.conv_bwd_plan(mode, dim, 10**6, 132)
    assert plan.tm == plan.t == 64 and plan.warps == 4
    assert plan.smem <= 232_448
    assert plan.blocks_per_sm == (2 if dim <= 64 else 1)
    assert plan.blocks_per_sm * (plan.smem + ops._BLOCK_RESERVED) \
        <= ops._SM_SHARED
    assert plan.grid == 132 * plan.blocks_per_sm
    assert ops.conv_bwd_plan(mode, dim, 5, 132).grid == 5
    d_in = (3 if mode == "atom" else 4) * dim
    assert plan.k_chunks == -(-d_in // 32)
    assert ops.conv_bwd_partials(mode, dim) == d_in * 2 * dim + 6 * dim


def test_conv_bwd_plan_refuses_other_modes():
    with pytest.raises(ValueError):
        ops.conv_bwd_plan("sym", 64, 10, 132)
    with pytest.raises(ValueError):
        ops.conv_bwd_plan("atom", 24, 10, 132)


def test_id_sorts_are_kept_for_the_ids_a_step_shares(monkeypatch):
    """The backward's sorts of the ids are made once for the id tensors
    that a step's convs share: the same tensor, unchanged, takes the kept
    sort; an in-place change or another tensor sorts anew; at most
    ``_ID_SORTS_KEPT`` are kept.  (The row starts come from a kernel,
    left out here.)"""
    launched = []
    monkeypatch.setattr(ops, "_launch",
                        lambda lib, fn, *a: launched.append(fn))
    monkeypatch.setattr(ops, "_stream", lambda device: 0)
    monkeypatch.setattr(ops, "_ID_SORTS", {})
    ids = torch.tensor([3, 1, 3, 0, 1], dtype=torch.int32)
    perm, starts = ops._sorted_ids((ids,), 4)
    assert perm.tolist() == [3, 1, 4, 0, 2] and starts.shape == (5,)
    assert ops._sorted_ids((ids,), 4)[0] is perm
    assert launched == ["sorted_row_starts"]
    ids.add_(0)  # a new version of the same tensor
    again = ops._sorted_ids((ids,), 4)[0]
    assert again is not perm and torch.equal(again, perm)
    other = ids.clone()
    assert ops._sorted_ids((other,), 4)[0] is not again
    both = ops._sorted_ids((ids, other), 4)[0]
    assert both.tolist() == [3, 8, 1, 4, 6, 9, 0, 2, 5, 7]
    for _ in range(2 * ops._ID_SORTS_KEPT):
        ops._sorted_ids((ids.clone(),), 4)
    assert len(ops._ID_SORTS) == ops._ID_SORTS_KEPT
