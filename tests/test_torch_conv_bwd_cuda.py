"""The fused convs' backward kernel (kernels 2 and 3, ``conv_bwd_kernel``
in ``csrc/message_passing_bwd.cu``) against the chunked recompute it
replaces and against the JAX package's custom VJPs, on the card.  Every
test is marked ``cuda`` and skips without a card; on the card:

    python -m pytest -q -s tests/test_torch_conv_bwd_cuda.py

Each case takes the gradient of ``sum(out * r)`` for every float operand
through the kernel (the default: grad mode is off inside the backward),
twice, for equal bits, and through the recompute, which the wrappers take
where the backward is itself differentiated (``create_graph``).  The
forms: the directed store, the undirected store's ``pair`` and, for the
atom conv, ``pair`` + ``und``; at the first training batch of 128
crystals, at a serving batch of 16 replicas of 16-64 atoms and on ragged
layouts at every width; on f32 operands and on bf16 operands, which both
backwards widen to f32.  Beside them, each form at the operands of
tests/conv_bwd_jax_cases.py against the JAX package's cotangents stored in
tests/conv_bwd_jax.npz (``jax.vjp`` on the CPU; JAX does not run here).

Limit: every cotangent within ``F32_REL`` = 1e-4 of the reference's
largest element.  The two sum in other orders: the kernel's dW, db and
LayerNorm partials over 64-edge tiles and its blocks, the recompute's over
its chunk; the kernel's scattered rows in the order of a stable sort of
their ids, the recompute's as its gathers' backward adds them; its
products split f32 against the recompute's f32 GEMMs.  A cotangent
element is a sum of up to ~10^5 f32 terms whose magnitudes reach the
largest, so each order is within ~10^5 roundings of 2^-24 (6e-3) of it at
worst and ~sqrt(10^5) (2e-5) typically.  bf16 cotangents also within one
bf16 unit in the last place of each element (at most 2^-7 of it): both
round to bf16 one f32 value that may differ in its last bits, and the two
may round to neighbours.  The line printed for each case gives each
cotangent's max |kernel - reference| over the reference's largest
element.
"""
import math

import numpy as np
import pytest
import torch

import conv_bwd_jax_cases as jax_cases
from repro_torch.batching import capacity_for
from repro_torch.configs import chgnet_mptrj
from repro_torch.core import chgnet
from repro_torch.data import BatchIterator, SyntheticConfig, make_dataset
from repro_torch.kernels import build, ops
from repro_torch.optim.tree import leaves
from repro_torch.train.trainer import chgnet_loss_fn, grads_of, params_on

pytestmark = pytest.mark.cuda

F32_REL = 1e-4
BF16_ULP = 2.0 ** -7
TRAIN_BATCH = chgnet_mptrj.BATCH_SIZE
SERVE = SyntheticConfig(num_crystals=16, min_atoms=16, max_atoms=64,
                        lognormal_mu=math.log(40.0), lognormal_sigma=0.4)
WRAPPERS = {"atom": ops.fused_atom_conv, "bond": ops.fused_bond_conv}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load_libraries()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def batches(card):
    """The first training batch of 128 crystals (the JAX package's default
    synthetic dataset) and one serving batch of 16 replicas."""
    out = {}
    for name, cfg, size in (("train", SyntheticConfig(), TRAIN_BATCH),
                            ("serve", SERVE, 16)):
        ds = make_dataset(cfg)
        it = BatchIterator(ds, size, 1, capacity_for(ds, size), seed=0)
        out[name] = next(iter(it)).to(card)
    return out


@pytest.fixture(scope="module")
def params(card):
    return params_on(chgnet.chgnet_init(0, chgnet_mptrj.FAST_FUSED), card)


def _grads(kind, args, kw, r, recompute: bool):
    """The gradients of sum(out * r) for every float operand, and the
    number of kernel backwards taken."""
    wrapper = WRAPPERS[kind]
    idx = [i for i, x in enumerate(args)
           if torch.is_tensor(x) and x.is_floating_point()]
    args = list(args)
    for i in idx:
        args[i] = args[i].detach().clone().requires_grad_()
    n0 = wrapper.bwd_launches
    out = wrapper(*args, **kw)
    grads = torch.autograd.grad((out.float() * r).sum(),
                                [args[i] for i in idx],
                                create_graph=recompute)
    torch.cuda.synchronize()
    return [g.detach() for g in grads], wrapper.bwd_launches - n0


def _compare(label, kind, args, kw, seed=0):
    """Kernel against recompute; returns each cotangent's relative
    error."""
    wrapper = WRAPPERS[kind]
    with torch.no_grad():
        shape = wrapper(*args, **kw).shape
    gen = torch.Generator(device=args[0].device).manual_seed(seed)
    r = torch.randn(shape, generator=gen, device=args[0].device)
    got, n_kernel = _grads(kind, args, kw, r, recompute=False)
    again, _ = _grads(kind, args, kw, r, recompute=False)
    want, n_plain = _grads(kind, args, kw, r, recompute=True)
    assert (n_kernel, n_plain) == (1, 0), label
    assert all(torch.equal(x, y) for x, y in zip(got, again)), \
        f"{label}: two kernel backwards gave different bits"
    rels = []
    for i, (k, p) in enumerate(zip(got, want)):
        assert k.dtype == p.dtype and k.shape == p.shape, (label, i)
        assert torch.isfinite(k).all(), (label, i)
        k, p = k.float(), p.float()
        scale = p.abs().max().item() if p.numel() else 0.0
        diff = (k - p).abs()
        err = diff.max().item() if p.numel() else 0.0
        rels.append(err / scale if scale else err)
        bound = F32_REL * scale
        if args[0].dtype == torch.bfloat16:
            bound = BF16_ULP * p.abs() + bound
        assert bool((diff <= bound).all()), \
            f"{label}: cotangent {i}: max |k - p| {err} (largest {scale})"
    print(f"conv_bwd {label}: rel " + " ".join(f"{x:.2e}" for x in rels),
          flush=True)
    return rels


def _batch_cases(params, batch):
    """The forms the convs take on the main path and the undirected
    store, at the operands the first block hands them."""
    half, sym = chgnet_mptrj.FAST_FUSED_HALF, chgnet_mptrj.FAST_FUSED_SYM
    with torch.no_grad():
        v, e, a, e_a, e_b = chgnet.embed(params, chgnet_mptrj.FAST_FUSED,
                                         batch)[:5]
        _, e_h, a_h, e_ah, e_bh = chgnet.embed(params, half, batch)[:5]
        e_u = chgnet.embed(params, sym, batch)[1]
    blk = params["blocks"][0]
    am = tuple(blk["atom_mlp"][k].detach()
               for k in ("w", "b", "ln_scale", "ln_bias"))
    bm = tuple(blk["bond_mlp"][k].detach()
               for k in ("w", "b", "ln_scale", "ln_bias"))
    atom_ids = (batch.bond_center, batch.bond_nbr, batch.bond_offsets)
    center = batch.bond_center[batch.angle_ij.long()]
    bond_ids = (batch.angle_ij, batch.angle_ik, center, batch.angle_offsets)
    pair = batch.bond_pair
    return {
        "atom": ("atom", (v, e, e_a) + am + atom_ids, {}),
        "atom[pair]": ("atom", (v, e_h, e_ah) + am + atom_ids,
                       {"pair": pair}),
        "atom[pair+und]": ("atom", (v, e_u, e_ah) + am + atom_ids,
                           {"pair": pair, "und_features": True}),
        "bond": ("bond", (v, e, a, e_b) + bm + bond_ids, {}),
        "bond[pair]": ("bond", (v, e_h, a_h, e_bh) + bm + bond_ids,
                       {"pair": pair}),
    }


def _bf16(args):
    return tuple(x.to(torch.bfloat16) if torch.is_tensor(x)
                 and x.is_floating_point() else x for x in args)


@pytest.mark.parametrize("which", ("train", "serve"))
@pytest.mark.parametrize("dtype", ("f32", "bf16"))
def test_kernel_matches_recompute_on_batches(card, batches, params, which,
                                             dtype):
    for name, (kind, args, kw) in _batch_cases(params,
                                               batches[which]).items():
        if dtype == "bf16":
            args = _bf16(args)
        _compare(f"{name} {which} {dtype}", kind, args, kw)


def _layout(rng, lens, tail, card):
    rows, n_real = len(lens), sum(lens)
    seg = np.zeros(n_real + tail, np.int32)
    seg[:n_real] = np.repeat(np.arange(rows), lens)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return (torch.from_numpy(seg).to(card), torch.from_numpy(offs).to(card),
            rows, n_real + tail)


LAYOUTS = {
    "one row of 700 edges": ([700, 3, 0, 5], 20),
    "rows straddling tiles": (list(range(0, 300, 25)), 5),
    "every row empty": ([0] * 6, 0),
    "no real edge, padded tail": ([0] * 6, 40),
    "a single row": ([300], 0),
    "many rows over every block": ([(7 * i) % 61 for i in range(3000)], 33),
}


@pytest.mark.parametrize("dim", ops.CONV_WIDTHS)
@pytest.mark.parametrize("layout", tuple(LAYOUTS))
def test_kernel_matches_recompute_on_layouts(card, dim, layout):
    """The edge partition, the tiles and the carried rows at their edges,
    every form, at every width the kernel is built for."""
    rng = np.random.default_rng(dim + len(layout))
    seg, offs, rows, n_edges = _layout(rng, *LAYOUTS[layout], card)

    def f(*shape):
        return torch.from_numpy(
            rng.normal(0, 1, shape).astype(np.float32)).to(card)

    def ids(high, n):
        return torch.from_numpy(
            rng.integers(0, high, n).astype(np.int32)).to(card)

    def mlp(d_in):
        return (f(d_in, 2 * dim) * 0.1, f(2 * dim),
                f(2 * dim) * 0.2 + 1.0, f(2 * dim))

    eu, atoms = n_edges // 2 + 1, 7
    pair, pair_b = ids(eu, n_edges), ids(eu, rows)
    atom = (seg, ids(rows, n_edges), offs)
    # the bond conv's centers: the center atom of each angle's bond ij,
    # the same along a row (center_ids = bond_center[angle_ij])
    bond = (seg, ids(rows, n_edges), ids(atoms, rows)[seg.long()], offs)
    cases = {
        "atom": ("atom", (f(rows, dim), f(n_edges, dim), f(n_edges, dim))
                 + mlp(3 * dim) + atom, {}),
        "atom[pair]": ("atom", (f(rows, dim), f(n_edges, dim), f(eu, dim))
                       + mlp(3 * dim) + atom, {"pair": pair}),
        "atom[pair+und]": ("atom", (f(rows, dim), f(eu, dim), f(eu, dim))
                           + mlp(3 * dim) + atom,
                           {"pair": pair, "und_features": True}),
        "bond": ("bond", (f(atoms, dim), f(rows, dim), f(n_edges, dim),
                          f(rows, dim)) + mlp(4 * dim) + bond, {}),
        "bond[pair]": ("bond", (f(atoms, dim), f(rows, dim),
                                f(n_edges, dim), f(eu, dim))
                       + mlp(4 * dim) + bond, {"pair": pair_b}),
    }
    for name, (kind, args, kw) in cases.items():
        _compare(f"{name} {layout} D {dim}", kind, args, kw)
        if dim == 64:
            _compare(f"{name} {layout} D {dim} bf16", kind, _bf16(args), kw)


def test_double_backward_through_fused_convs(card, batches, monkeypatch):
    """The autodiff readout on the fused convs (``readout="autodiff"``,
    ``conv_impl="fused"``): its forces' create-graph backward recomputes
    (grad mode on), and only the loss's first-order backward takes the
    kernel, 4 atom and 3 bond convs; every gradient leaf matches the same
    step with the convs' kernel refused, so that every conv backward
    recomputes.  Beside it, the step's gradients taken with
    ``create_graph`` (every backward with grad mode on) are printed."""
    cfg = chgnet_mptrj.FAST_FUSED.with_(readout="autodiff")
    params = params_on(chgnet.chgnet_init(0, cfg), card)
    batch = batches["train"]
    ops.reset_launch_counts()
    loss = chgnet_loss_fn(params, cfg, batch, chgnet_mptrj.LOSS)[0]
    assert (ops.fused_atom_conv.bwd_launches,
            ops.fused_bond_conv.bwd_launches) == (0, 0)
    assert ops.fused_atom_conv.launches == 4
    got = grads_of(loss, params)
    torch.cuda.synchronize()
    assert (ops.fused_atom_conv.bwd_launches,
            ops.fused_bond_conv.bwd_launches) == (4, 3)
    flat = leaves(params)
    loss = chgnet_loss_fn(params, cfg, batch, chgnet_mptrj.LOSS)[0]
    graph = [torch.zeros_like(p) if g is None else g.detach() for p, g in zip(
        flat, torch.autograd.grad(loss, flat, allow_unused=True,
                                  create_graph=True))]
    with monkeypatch.context() as m:
        m.setattr(ops, "_bwd_kernel", lambda g: False)
        want = grads_of(chgnet_loss_fn(params, cfg, batch,
                                       chgnet_mptrj.LOSS)[0], params)
    torch.cuda.synchronize()
    assert (ops.fused_atom_conv.bwd_launches,
            ops.fused_bond_conv.bwd_launches) == (4, 3)

    def rel(k, p):
        scale = p.abs().max().item()
        err = (k - p).abs().max().item()
        return err / scale if scale else err, err, scale

    worst = 0.0
    for i, (k, p) in enumerate(zip(got, want)):
        r, err, scale = rel(k, p)
        assert err <= F32_REL * scale, (i, err, scale)
        worst = max(worst, r)
    by_graph = [rel(k, p)[0] for k, p in zip(got, graph)]
    print(f"conv_bwd double backward: {len(got)} leaves, worst rel "
          f"{worst:.2e}; against create_graph: worst {max(by_graph):.2e} "
          f"(leaf {by_graph.index(max(by_graph))})", flush=True)


@pytest.mark.parametrize("form", jax_cases.FORMS)
def test_kernel_matches_jax_cotangents(card, form):
    """Each form's kernel backward at the operands of
    tests/conv_bwd_jax_cases.py (a row across a tile, edges over several
    blocks, empty rows, a padded tail; the bond conv's centers differing
    within a row) against the JAX package's ``jax.vjp`` there, stored in
    tests/conv_bwd_jax.npz; the recompute beside it."""
    kind, floats, ints, kw = jax_cases.case(form)
    to = lambda x: torch.from_numpy(x).to(card)  # noqa: E731
    args = tuple(map(to, floats)) + tuple(map(to, ints))
    kw = {k: to(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    r = to(jax_cases.cotangent(form))
    want = jax_cases.load()[form]
    rels = {}
    for path, recompute in (("kernel", False), ("recompute", True)):
        got, n_kernel = _grads(kind, args, kw, r, recompute)
        assert n_kernel == (0 if recompute else 1), (form, path)
        worst = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            g = g.cpu().numpy()
            scale = float(np.abs(w).max())
            err = float(np.abs(g - w).max())
            assert err <= F32_REL * scale, \
                f"{form} {path}: cotangent {i}: {err} (largest {scale})"
            worst = max(worst, err / scale if scale else err)
        rels[path] = worst
    print(f"conv_bwd {form} against JAX: worst rel kernel "
          f"{rels['kernel']:.2e}, recompute {rels['recompute']:.2e}",
          flush=True)
