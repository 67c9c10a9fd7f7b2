"""Numerics of the split-f32 (3xTF32) products of the CUDA kernels 7
(GatedMLP, ``csrc/gated_mlp.cu``), 11 (flash attention in f32,
``csrc/flash_attention.cu``), 10 (the fused feed-forward in f32,
``csrc/swiglu.cu``, with its split-K and the tensor cores' rounding of
each product's sum toward zero), 2 and 3 (the atom and bond convs), 5 (the
symmetric conv's phase A) and 4 (the force readouts, with and without the
virial; all four in ``csrc/message_passing.cu``), emulated on the CPU, and
their launch plans, partitions and width checks.

The kernels split each f32 operand x into TF32 parts hi = tf32(x) and lo =
tf32(x - hi) (``cvt.rna``: round to nearest, ties away from zero) and
accumulate, for every 8-wide step of the sum, a_lo b_hi, then a_hi b_lo,
then a_hi b_hi in f32 (``hopper.cuh`` ``mma_split``).  The emulation here
does the same with f32 matmuls of TF32 values (their products are exact in
f32) and is held to a float64 product through the GatedMLP's LayerNorms
and gate and through attention's softmax, within ``1e-5 * max(1,
max|ref|)``; one TF32 product per f32 product does not meet that bound,
which is why the kernels split.  The convs and the force readouts are
emulated as their kernels run them, down to the ordered row sums over the
launch's partition (and the readout's per-crystal sum, whatever the order
of the crystal slots), and held to the float64 plain versions, the convs
for each mirror operand.  The bf16 paths of kernels 2, 3 and 4a
(precision "mixed") are emulated too: one m16n8k16 bf16 product per 16
columns into an f32 accumulator that rounds toward zero, the f32
epilogue and row sums, the output rounded to bf16 once; held to float64
within one bf16 rounding.  The card holds the kernels themselves to their
plain versions (``chip_smoke.py``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 1e-5


def round_tf32(x):
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to the
    magnitude bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def mma_emulated(a, b, split: bool = True):
    """a (..., M, K) @ b (..., K, N) in f32 as the kernels' products run:
    per 8-wide step of K, the split's three TF32 products (small ones
    first) or one TF32 product, accumulated in f32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k in range(0, a.shape[-1], 8):
        ks = slice(k, k + 8)
        if split:
            out = out + a_lo[..., ks] @ b_hi[..., ks, :]
            out = out + a_hi[..., ks] @ b_lo[..., ks, :]
        out = out + a_hi[..., ks] @ b_hi[..., ks, :]
    return out


def _normal(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.normal(0.0, scale, shape).astype(np.float32))


def _err(got, want) -> float:
    """max|got - want| / max(1, max|want|), in float64."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / max(1.0, want.abs().max().item())
            ).item()


# ---------------------------------------------------------------------------
# The split itself
# ---------------------------------------------------------------------------

def test_round_tf32_rounds_to_ten_mantissa_bits():
    rng = np.random.default_rng(0)
    x = _normal(rng, 4096) * torch.logspace(-20, 20, 4096)
    hi, lo = split_tf32(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    # hi is within half a TF32 ulp (2^-11 relative), hi + lo within 2^-22
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((x.double() - hi.double() - lo.double()).abs()
            <= x.abs().double() * 2.0 ** -21).all()


def test_round_tf32_ties_go_away_from_zero():
    # 1 + 2^-11 lies halfway between the TF32 values 1 and 1 + 2^-10
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 3 * 2.0 ** -11], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                         1.0 + 2 * 2.0 ** -10], dtype=torch.float32)
    assert torch.equal(round_tf32(tie), want)


# ---------------------------------------------------------------------------
# Kernel 7: GatedMLP at its path widths (d_in 192, 256; 2D = 128)
# ---------------------------------------------------------------------------

def _mlp_inputs(d_in: int, m: int = 300, d: int = 64, seed: int = 0):
    rng = np.random.default_rng(seed + d_in)
    return (_normal(rng, m, d_in), _normal(rng, d_in, 2 * d,
                                           scale=d_in ** -0.5),
            _normal(rng, 2 * d, scale=0.1),
            1.0 + _normal(rng, 2 * d, scale=0.1), _normal(rng, 2 * d,
                                                          scale=0.1))


def _mlp_emulated(x, w, b, lns, lnb, split: bool):
    """The kernel's GEMM emulated, then ``ref.gated_mlp_packed_ref``'s bias,
    LayerNorms and gate (through an identity GEMM, exact in f32)."""
    y = mma_emulated(x, w, split)
    eye = torch.eye(w.shape[1], dtype=torch.float32)
    return ref.gated_mlp_packed_ref(y, eye, b, lns, lnb)


@pytest.mark.parametrize("d_in", [192, 256])
def test_split_gated_mlp_matches_float64(d_in):
    args = _mlp_inputs(d_in)
    want = ref.gated_mlp_packed_ref(*(t.double() for t in args))
    assert _err(_mlp_emulated(*args, split=True), want) <= TOL
    # the plain f32 version meets the same bound
    assert _err(ref.gated_mlp_packed_ref(*args), want) <= TOL


@pytest.mark.parametrize("d_in", [192, 256])
def test_single_tf32_gated_mlp_misses_the_bound(d_in):
    args = _mlp_inputs(d_in)
    want = ref.gated_mlp_packed_ref(*(t.double() for t in args))
    assert _err(_mlp_emulated(*args, split=False), want) > TOL


# ---------------------------------------------------------------------------
# Kernel 11 in f32: attention at D 64 / 128 / 256, ragged S
# ---------------------------------------------------------------------------

def _attn_inputs(d: int, sq: int = 77, sk: int = 129, seed: int = 0):
    rng = np.random.default_rng(seed + d)
    return tuple(_normal(rng, 1, 2, s, d) for s in (sq, sk, sk))


def _attn_emulated(q, k, v, causal: bool, split: bool):
    """Kernel 11's f32 path with emulated products: s = q k^T in the split,
    scaled, masked from the top-left corner, softmax in f32, then p v in
    the split."""
    scale = float(q.shape[-1] ** -0.5)
    s = mma_emulated(q, k.transpose(-1, -2), split) * scale
    if causal:
        rows = torch.arange(s.shape[-2])[:, None]
        cols = torch.arange(s.shape[-1])[None, :]
        s = torch.where(rows >= cols, s, torch.finfo(s.dtype).min)
    return mma_emulated(torch.softmax(s, dim=-1), v, split)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_split_attention_matches_float64(d, causal):
    q, k, v = _attn_inputs(d)
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                   causal=causal, scale=float(d ** -0.5))
    assert _err(_attn_emulated(q, k, v, causal, split=True), want) <= TOL
    plain = ref.flash_attention_ref(q, k, v, causal=causal,
                                    scale=float(d ** -0.5))
    assert _err(plain, want) <= TOL


@pytest.mark.parametrize("d", [64, 128, 256])
def test_single_tf32_attention_misses_the_bound(d):
    q, k, v = _attn_inputs(d)
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                   causal=False, scale=float(d ** -0.5))
    assert _err(_attn_emulated(q, k, v, False, split=False), want) > TOL


# ---------------------------------------------------------------------------
# Kernel 10 in f32: the fused feed-forward (csrc/swiglu.cu)
# ---------------------------------------------------------------------------

def _swiglu_inputs(m: int, f: int, d: int = 64, seed: int = 0):
    rng = np.random.default_rng(seed + m + f)
    return (_normal(rng, m, d), _normal(rng, d, f, scale=d ** -0.5),
            _normal(rng, d, f, scale=d ** -0.5),
            _normal(rng, f, d, scale=f ** -0.5))


def _swiglu_emulated(x, wg, wu, wd, act: str, split: bool):
    """Kernel 10's f32 path with emulated products: g and u in the split,
    h = act(g) u in f32, then the down product over the K slices of
    ``ops.swiglu_plan``, each slice's partial in the split, the partials
    added in split order."""
    h = ref.swiglu_act(mma_emulated(x, wg, split), act) \
        * mma_emulated(x, wu, split)
    (m, d), f = x.shape, wg.shape[1]
    plan = ops.swiglu_plan(m, d, f, 4, 132)
    out = torch.zeros(m, d, dtype=torch.float32)
    for k0 in range(0, f, plan.k_split):
        ks = slice(k0, k0 + plan.k_split)
        out = out + mma_emulated(h[:, ks], wd[ks], split)
    return out, plan.splits


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("m,f", [(16, 160), (16, 1000), (37, 160),
                                 (37, 1000)])
def test_split_swiglu_matches_float64(m, f, act):
    args = _swiglu_inputs(m, f)
    want = ref.fused_swiglu_ref(*(t.double() for t in args), act)
    got, splits = _swiglu_emulated(*args, act, split=True)
    assert splits > 1  # the down product's K runs in slices
    assert _err(got, want) <= TOL
    assert _err(ref.fused_swiglu_ref(*args, act), want) <= TOL


def _round_toward_zero(x64):
    """float64 -> float32, rounded toward zero."""
    y = x64.float()
    over = y.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def mma_rz_emulated(a, b, stage_k: int):
    """a (M, K) @ b (K, N) in split f32 with the tensor cores' rounding:
    each mma.sync adds its 8 exact TF32 products into its accumulator and
    rounds the sum toward zero.  The products of each ``stage_k`` slice of
    K go into a fresh accumulator, which is added into the f32 result
    (rounding to nearest) at the end of the slice, as csrc/swiglu.cu does
    once a ring stage; ``stage_k = K`` is one accumulator carried over all
    of K."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    out = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for s0 in range(0, a.shape[1], stage_k):
        part = torch.zeros_like(out)
        for k in range(s0, min(s0 + stage_k, a.shape[1]), 8):
            ks = slice(k, k + 8)
            for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                part = _round_toward_zero(
                    part.double() + x[:, ks].double() @ y[ks].double())
        out = out + part
    return out


def round_bf16(x):
    """f32 -> the nearest bf16 value (ties to even), as f32."""
    return x.to(torch.bfloat16).float()


def mma_bf16_emulated(a, b):
    """a (M, K) @ b (K, N) of bf16 values as the bf16 paths of kernels 2,
    3 and 4a run it: one mma.sync m16n8k16 a 16-wide step of K, its 16
    products (exact) summed into the f32 accumulator, which the tensor
    cores round toward zero; one accumulator over all of K (the convs'
    d_in = 3D or 4D, the force readout's D)."""
    out = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 16):
        ks = slice(k, k + 16)
        out = _round_toward_zero(out.double()
                                 + a[:, ks].double() @ b[ks].double())
    return out


@pytest.mark.parametrize("k", [192, 256])
def test_bf16_product_accumulates_in_f32(k):
    """The bf16 product at the convs' K (3D and 4D at D = 64: 12 and 16
    steps into one accumulator): within 1e-5 of the float64 product of the
    same bf16 operands, far from the drift of K = 14336 below; the one
    rounding left is the output's to bf16."""
    rng = np.random.default_rng(k)
    a = round_bf16(_normal(rng, 300, k))
    b = round_bf16(_normal(rng, k, 128, scale=k ** -0.5))
    assert _err(mma_bf16_emulated(a, b), a.double() @ b.double()) <= TOL


@pytest.mark.parametrize("stage_k,meets", [(32, True), (64, True),
                                           (14336, False)])
def test_swiglu_down_product_sums_a_stage_at_a_time(stage_k, meets):
    """The down product's K = 14336 at llama3-8b's F: with the tensor
    cores' round-toward-zero, one accumulator over all of K (5,376
    products into it) drifts past the bound; the kernel's fresh
    accumulator per ring stage (K 32 in the narrow plan, 64 in the wide
    one) meets it."""
    rng = np.random.default_rng(1)
    h = _normal(rng, 16, 14336)
    wd = _normal(rng, 14336, 64, scale=14336 ** -0.5)
    want = h.double() @ wd.double()
    assert (_err(mma_rz_emulated(h, wd, stage_k), want) <= TOL) == meets


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_single_tf32_swiglu_misses_the_bound(act):
    args = _swiglu_inputs(37, 1000)
    want = ref.fused_swiglu_ref(*(t.double() for t in args), act)
    assert _err(_swiglu_emulated(*args, act, split=False)[0], want) > TOL


# ---------------------------------------------------------------------------
# The GatedMLP wrapper's checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [4, 24, 256])
def test_gated_mlp_kernel_refuses_widths_it_is_not_built_for(d):
    """Widths outside ``GATED_MLP_WIDTHS`` raise before any launch (the
    wrapper never hands a CUDA tensor to the plain version)."""
    assert d not in ops.GATED_MLP_WIDTHS
    args = _mlp_inputs(40, m=5, d=d)
    with pytest.raises(ValueError, match="D = width / 2"):
        ops._gated_mlp_cuda(*args)
    assert ops.fused_gated_mlp_packed.launches == 0


# ---------------------------------------------------------------------------
# Kernels 2 and 3: the split-f32 convs (csrc/message_passing.cu)
# ---------------------------------------------------------------------------

CONV_D = 64


def _ragged_offsets(rng, rows: int, max_len: int, empty: float = 0.3):
    """CSR offsets of ``rows`` rows of 1..max_len edges, a share of them
    empty."""
    lens = rng.integers(1, max_len + 1, rows)
    lens[rng.random(rows) < empty] = 0
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


def _conv_inputs(mode: str, variant: str, seed: int = 0):
    """A ragged batch for one conv and mirror variant: the wrapper's
    arguments, the plain version's extra arguments, and the GEMM input's
    parts and envelope factors as (table, row ids or None) pairs, as the
    kernel gathers them."""
    rng = np.random.default_rng(seed)
    d, n_atoms, eu = CONV_D, 9, 40
    rows = n_atoms if mode == "atom" else 60
    offs = _ragged_offsets(rng, rows, 40 if mode == "atom" else 6)
    n_real = int(offs[-1])
    n_edges = n_real + 11  # a padded tail

    def ids(high, n):
        return torch.from_numpy(rng.integers(0, high, n).astype(np.int32))

    seg = torch.zeros(n_edges, dtype=torch.int32)
    seg[:n_real] = torch.from_numpy(np.repeat(np.arange(rows),
                                              np.diff(offs)).astype(np.int32))
    offsets = torch.from_numpy(offs.astype(np.int32))
    d_in = (3 if mode == "atom" else 4) * d
    mlp = (_normal(rng, d_in, 2 * d, scale=d_in ** -0.5),
           _normal(rng, 2 * d, scale=0.1),
           1.0 + _normal(rng, 2 * d, scale=0.1),
           _normal(rng, 2 * d, scale=0.1))
    if mode == "atom":
        pair = ids(eu, n_edges)
        nbr = ids(n_atoms, n_edges)
        v = _normal(rng, n_atoms, d)
        e = _normal(rng, eu if variant == "pair+und" else n_edges, d)
        e_a = _normal(rng, n_edges if variant == "directed" else eu, d)
        args = (v, e, e_a) + mlp + (seg, nbr, offsets)
        mirror = None if variant == "directed" else pair
        extra = {"directed": (), "pair": (pair,),
                 "pair+und": (pair, True)}[variant]
        parts = [(v, seg), (v, nbr),
                 (e, pair if variant == "pair+und" else None)]
        env = [(e_a, mirror)]
    else:
        pair = ids(eu, rows)
        ik, ctr = ids(rows, n_edges), ids(n_atoms, n_edges)
        v, e, a = (_normal(rng, n, d) for n in (n_atoms, rows, n_edges))
        e_b = _normal(rng, rows if variant == "directed" else eu, d)
        args = (v, e, a, e_b) + mlp + (seg, ik, ctr, offsets)
        extra = () if variant == "directed" else (pair,)
        parts = [(v, ctr), (e, seg), (e, ik), (a, None)]
        env = [(e_b, seg if variant == "directed" else pair[seg.long()]),
               (e_b, ik if variant == "directed" else pair[ik.long()])]
    return args, extra, parts, env, offsets, mlp


def _conv_emulated(mode, parts, env, mlp, offsets, bf16: bool = False):
    """A conv as its kernel runs it: each real edge's input row gathered
    from its parts, the split GEMM (``bf16``: the bf16 path's product of
    bf16 operands), bias, LayerNorms and gate, the envelope factors, then
    each row's edges summed in f32 in CSR order, row by row of each block
    of the launch's partition."""
    offs = offsets.long()
    n_real = int(offs[-1])

    def rows(t, i):
        return t[:n_real] if i is None else t[i[:n_real].long()]

    x = torch.cat([rows(t, i) for t, i in parts], dim=1)
    if bf16:
        w, b, lns, lnb = mlp
        msg = ref.gated_mlp_packed_ref(
            mma_bf16_emulated(x, w), torch.eye(w.shape[1]), b, lns, lnb)
    else:
        msg = _mlp_emulated(x, *mlp, split=True)
    for t, i in env:
        msg = msg * rows(t, i)
    out = torch.zeros(offs.shape[0] - 1, msg.shape[1])
    plan = ops.conv_plan(mode, CONV_D, out.shape[0], 132)
    for r_lo, r_hi, _, _ in ops.conv_chunks(offs, plan):
        for r in range(r_lo, r_hi):
            acc = torch.zeros(msg.shape[1])
            for t in range(int(offs[r]), int(offs[r + 1])):
                acc = acc + msg[t]
            out[r] = acc
    return out


@pytest.mark.parametrize("mode,variant", [
    ("atom", "directed"), ("atom", "pair"), ("atom", "pair+und"),
    ("bond", "directed"), ("bond", "pair")])
def test_split_conv_matches_float64(mode, variant):
    """Kernels 2 and 3 emulated (split-f32 GEMM, ordered row sums) against
    the float64 plain version, for each mirror variant."""
    args, extra, parts, env, offsets, mlp = _conv_inputs(mode, variant)
    plain = ref.fused_atom_conv_ref if mode == "atom" \
        else ref.fused_bond_conv_ref
    want = plain(*(t.double() if t.is_floating_point() else t
                   for t in args), *extra)
    got = _conv_emulated(mode, parts, env, mlp, offsets)
    assert _err(got, want) <= TOL
    # the plain f32 version meets the same bound
    assert _err(plain(*args, *extra), want) <= TOL


# one bf16 rounding of an output, relative to max(1, max|ref|)
BF16_TOL = 2.0 ** -7


def _bf16(t):
    return t.to(torch.bfloat16) if t.is_floating_point() else t


@pytest.mark.parametrize("mode,variant", [
    ("atom", "directed"), ("atom", "pair"), ("atom", "pair+und"),
    ("bond", "directed"), ("bond", "pair")])
def test_bf16_conv_rounds_once(mode, variant):
    """Kernels 2 and 3's bf16 path emulated (bf16 operands, the bf16
    product into f32 accumulators, the f32 epilogue and ordered row sums,
    the output rounded to bf16 once) against the float64 plain version of
    the same bf16 operands, within one bf16 rounding; the plain version on
    bf16 tensors (f32 inside, rounded once) too."""
    args, extra, parts, env, offsets, mlp = _conv_inputs(mode, variant)
    args = tuple(round_bf16(t) if t.is_floating_point() else t
                 for t in args)
    parts = [(round_bf16(t), i) for t, i in parts]
    env = [(round_bf16(t), i) for t, i in env]
    mlp = tuple(round_bf16(t) for t in mlp)
    plain = ref.fused_atom_conv_ref if mode == "atom" \
        else ref.fused_bond_conv_ref
    want = plain(*(t.double() if t.is_floating_point() else t
                   for t in args), *extra)
    got = _conv_emulated(mode, parts, env, mlp, offsets, bf16=True)
    assert _err(_bf16(got), want) <= BF16_TOL
    bf = plain(*(_bf16(t) for t in args), *extra)
    assert bf.dtype == torch.bfloat16 and _err(bf, want) <= BF16_TOL


@pytest.mark.parametrize("d", [8, 16, 64])
def test_bf16_force_readout_rounds_once(d):
    """Kernel 4a's bf16 path emulated (W1 and e in bf16, x_hat widened to
    f32 by the wrapper, the bf16 product, silu, n . w2 and the row sums in
    f32, the forces rounded to bf16 once) against the float64 plain
    version of the same bf16 operands, within one bf16 rounding."""
    (e, x_hat, dist, w1, b1, w2, b2, seg, cry, offs, n_atoms,
     n_crys) = _readout_inputs(d)
    e, x_hat, w1, b1, w2, b2 = (round_bf16(t)
                                for t in (e, x_hat, w1, b1, w2, b2))
    want = ref.fused_force_readout_ref(
        *(t.double() for t in (e, x_hat, w1, b1, w2, b2)), seg, offs,
        n_atoms)
    forces, _ = _readout_emulated(e, x_hat, dist, w1, b1, w2, b2, offs,
                                  cry, n_crys, mma=mma_bf16_emulated)
    assert _err(_bf16(forces), want) <= BF16_TOL
    bf = ref.fused_force_readout_ref(
        *(_bf16(t) for t in (e, x_hat, w1, b1, w2, b2)), seg, offs, n_atoms)
    assert bf.dtype == torch.bfloat16 and _err(bf, want) <= BF16_TOL


@pytest.mark.parametrize("mode", ["atom", "bond", "force"])
@pytest.mark.parametrize("dim", ops.CONV_WIDTHS)
def test_bf16_plans_fit_the_card(mode, dim):
    """The bf16 plans (kernels 2, 3 and 4a): a block's shared memory and
    the blocks a SM fit, the tiles are the f32 plan's, and the stages take
    fewer bytes; kernel 5 has no bf16 path."""
    f32 = ops.conv_plan(mode, dim, 394_496, 132)
    bf = ops.conv_plan(mode, dim, 394_496, 132, itemsize=2)
    assert bf.smem < f32.smem and bf.smem <= 232_448
    assert bf.blocks_per_sm * (bf.smem + 1024) <= 233_472
    assert bf.blocks_per_sm >= f32.blocks_per_sm
    assert (bf.tm, bf.t, bf.k_chunks) == (f32.tm, f32.t, f32.k_chunks)
    assert bf.grid == bf.blocks_per_sm * 132
    with pytest.raises(ValueError, match="no 'sym' kernel"):
        ops.conv_plan("sym", dim, 100, 132, itemsize=2)


@pytest.mark.parametrize("mode", ["atom", "bond"])
@pytest.mark.parametrize("dim", ops.CONV_WIDTHS)
def test_conv_plan_fits_the_card(mode, dim):
    """Every width's plan fits a block's 227 KB of shared memory, its
    blocks per SM fit the SM's 228 KB (1 KB reserved per block), and its
    tile is whole warp tiles: two m16 tiles a warp, one at D = 128."""
    plan = ops.conv_plan(mode, dim, 394_496, 132)
    assert plan.smem <= 232_448
    assert plan.blocks_per_sm * (plan.smem + 1024) <= 233_472
    assert plan.blocks_per_sm == (2 if dim <= 64 else 1)
    assert plan.tm == plan.warps * (32 if dim <= 64 else 16)
    assert plan.tm % 16 == 0 and plan.t == plan.tm
    assert plan.grid == plan.blocks_per_sm * 132
    d_in = (3 if mode == "atom" else 4) * dim
    assert (plan.k_chunks - 1) * 32 < d_in <= plan.k_chunks * 32
    # a handful of rows: no more blocks than rows
    assert ops.conv_plan(mode, dim, 5, 132).grid == 5


_LAYOUTS = {
    "ragged, empty rows": lambda rng: _ragged_offsets(rng, 500, 70),
    "a row longer than a chunk": lambda rng: np.concatenate(
        [[0], np.cumsum([3, 0, 700, 5] + [2] * 50)]),
    "fewer edges than a chunk": lambda rng: _ragged_offsets(rng, 30, 3),
    "every row empty": lambda rng: np.zeros(41, np.int64),
}


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_conv_partition_owns_every_row_once(layout):
    """The partition of ``ops.conv_chunks``: the blocks' edge ranges are
    in order, disjoint and cover [0, offs[-1]); every non-empty row is
    owned by exactly one block, whole inside its edge range."""
    offs = _LAYOUTS[layout](np.random.default_rng(3)).astype(np.int64)
    n_rows, n_real = offs.shape[0] - 1, int(offs[-1])
    for grid in (1, 7, 264):
        plan = ops.conv_plan("atom", CONV_D, n_rows, 132)._replace(grid=grid)
        chunks = ops.conv_chunks(torch.from_numpy(offs), plan)
        assert len(chunks) == grid
        owner = np.full(n_rows, -1)
        pos = 0
        for c, (r_lo, r_hi, e_lo, e_hi) in enumerate(chunks):
            assert e_lo == pos and e_lo <= e_hi
            pos = e_hi
            for r in range(r_lo, r_hi):
                if offs[r + 1] > offs[r]:
                    assert owner[r] == -1
                    owner[r] = c
                    assert e_lo <= offs[r] and offs[r + 1] <= e_hi
        assert pos == n_real
        assert ((owner >= 0) == (np.diff(offs) > 0)).all()


def _lower_bound_warp(offs, hi: int, x: int) -> int:
    """``lower_bound_warp`` of csrc/message_passing.cu, its 32 lanes'
    probes and ballots written out."""
    lo = 0
    while hi - lo >= 32:
        step = (hi - lo + 31) // 32
        ge = [offs[min(lo + (lane + 1) * step - 1, hi - 1)] >= x
              for lane in range(32)]
        if not any(ge):
            return hi
        lane = ge.index(True)
        hi = min(lo + (lane + 1) * step - 1, hi - 1)
        lo += lane * step
    ge = [lo + lane >= hi or offs[lo + lane] >= x for lane in range(32)]
    return min(lo + ge.index(True), hi)


@pytest.mark.parametrize("rows", [1, 31, 32, 33, 1000, 394_496])
def test_lower_bound_warp_finds_the_first_row(rows):
    """The kernel's 32-ary search of the CSR offsets gives numpy's
    ``searchsorted(..., 'left')`` for every probe a block makes (its
    chunk's first edge and the end of its range, up to offs[-1])."""
    rng = np.random.default_rng(rows)
    offs = _ragged_offsets(rng, rows, 4)
    n_real = int(offs[-1])
    probes = {0, n_real, max(0, n_real - 1)} | set(
        rng.integers(0, n_real + 1, 40).tolist())
    for x in sorted(probes):
        assert _lower_bound_warp(offs, rows, x) == \
            np.searchsorted(offs, x, "left")


@pytest.mark.parametrize("d", [4, 24, 256])
@pytest.mark.parametrize("mode", ["atom", "bond"])
def test_conv_kernels_refuse_widths_they_are_not_built_for(mode, d):
    """Widths outside ``CONV_WIDTHS`` raise before any launch (the wrapper
    never hands a CUDA tensor to the plain version)."""
    assert d not in ops.CONV_WIDTHS
    rng = np.random.default_rng(0)
    n, rows = 12, 3
    offs = torch.tensor([0, 5, 5, n], dtype=torch.int32)
    seg = torch.tensor([0] * 5 + [2] * 7, dtype=torch.int32)

    def mlp(d_in):
        return (_normal(rng, d_in, 2 * d), _normal(rng, 2 * d),
                _normal(rng, 2 * d), _normal(rng, 2 * d))

    with pytest.raises(ValueError, match="built for D in"):
        if mode == "atom":
            ops._atom_conv_cuda(_normal(rng, rows, d), _normal(rng, n, d),
                                _normal(rng, n, d), *mlp(3 * d), seg, seg,
                                offs, None, False)
        else:
            ops._bond_conv_cuda(_normal(rng, rows, d), _normal(rng, rows, d),
                                _normal(rng, n, d), _normal(rng, rows, d),
                                *mlp(4 * d), seg, seg, seg, offs, seg, seg,
                                False)
    with pytest.raises(ValueError, match="built for D in"):
        ops.conv_plan(mode, d, rows, 132)
    assert ops.fused_atom_conv.launches == 0
    assert ops.fused_bond_conv.launches == 0


# ---------------------------------------------------------------------------
# Kernels 5 and 4: the symmetric conv's phase A and the force readouts
# ---------------------------------------------------------------------------

def _sym_inputs(d: int, n_real: int, seed: int = 0):
    """``sym_msg``'s arguments: 40 dedup rows of which the first
    ``n_real`` are real, a fifth of them self-image pairs (du1 == du2)."""
    rng = np.random.default_rng(seed + d)
    a_rows, eu, au = 9, 30, n_real + 7

    def ids(high):
        return torch.from_numpy(rng.integers(0, high, au).astype(np.int32))

    du1, du2 = ids(eu), ids(eu)
    du2[: max(1, n_real // 5)] = du1[: max(1, n_real // 5)]
    offsets = torch.zeros(eu + 1, dtype=torch.int32)
    offsets[-1] = 2 * n_real  # the kernel reads the real count only
    return (_normal(rng, a_rows, d), _normal(rng, eu, d),
            _normal(rng, au, d), _normal(rng, eu, d),
            _normal(rng, 4 * d, 2 * d, scale=(3 * d) ** -0.5),
            _normal(rng, 2 * d, scale=0.1),
            1.0 + _normal(rng, 2 * d, scale=0.1),
            _normal(rng, 2 * d, scale=0.1), ids(a_rows), du1, du2, offsets)


def _sym_emulated(v, e, a_u, e_b, w, b, lns, lnb, ctr, du1, du2, offsets):
    """Kernel 5 as it runs: the real rows' v[ctr], e[du1] + e[du2] (added
    in f32 before the split) and a_u rows, the split GEMM against W with
    its two e blocks folded in f32 (K = 3D, in the kernel's column order),
    bias, LayerNorms and gate, then the envelope factors."""
    d, n_real = v.shape[1], int(offsets[-1]) // 2
    w23 = torch.cat([w[:d], w[d:2 * d] + w[2 * d:3 * d], w[3 * d:]])
    i0, i1, i2 = (t[:n_real].long() for t in (ctr, du1, du2))
    x = torch.cat([v[i0], e[i1] + e[i2], a_u[:n_real]], dim=1)
    return _mlp_emulated(x, w23, b, lns, lnb, split=True) * e_b[i1] * e_b[i2]


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("n_real", [1, 33])
def test_split_sym_msg_matches_float64(d, n_real):
    """Kernel 5 emulated against the float64 plain version on the real
    rows (the kernel leaves the rest unwritten)."""
    args = _sym_inputs(d, n_real)
    want = ref.sym_msg_ref(*(t.double() if t.is_floating_point() else t
                             for t in args[:11]))[:n_real]
    assert _err(_sym_emulated(*args), want) <= TOL
    assert _err(ref.sym_msg_ref(*args[:11])[:n_real], want) <= TOL


# crystal of each of the 30 atom rows of ``_readout_inputs``: slot 1 holds
# atoms with no bonds, slot 3 none at all
_ROW_CRYSTALS = {
    # the rows of a crystal contiguous, slots in order, as the packer lays
    # batches out
    "packed": np.repeat([0, 1, 2], [12, 6, 12]),
    # the same crystals with their slots permuted: 2, then 1, then 0
    "permuted": np.repeat([2, 1, 0], [12, 6, 12]),
    # crystals whose rows interleave
    "interleaved": np.tile([0, 2, 1, 2, 0, 1], 5),
}


def _readout_inputs(d: int, seed: int = 0, layout: str = "packed"):
    """A ragged readout batch: 30 atom rows in 4 crystal slots, bonds
    sorted by center, a row's bonds in its atom's crystal, then a padded
    tail."""
    rng = np.random.default_rng(seed + d)
    lens = rng.integers(0, 60, 30)
    row_cry = _ROW_CRYSTALS[layout]
    lens[row_cry == 1] = 0
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    n_real = int(offs[-1])
    n_edges = n_real + 13
    seg = np.zeros(n_edges, np.int32)
    seg[:n_real] = np.repeat(np.arange(30), lens)
    cry = np.zeros(n_edges, np.int32)
    cry[:n_real] = row_cry[seg[:n_real]]
    x_hat = _normal(rng, n_edges, 3)
    x_hat = x_hat / x_hat.norm(dim=1, keepdim=True)
    return (_normal(rng, n_edges, d), x_hat,
            torch.from_numpy(rng.uniform(0.5, 5.0, n_edges).astype(
                np.float32)),
            _normal(rng, d, d, scale=d ** -0.5), _normal(rng, d, scale=0.1),
            _normal(rng, d, 1, scale=d ** -0.5), _normal(rng, 1, scale=0.1),
            torch.from_numpy(seg), torch.from_numpy(cry),
            torch.from_numpy(offs), 30, 4)


def _butterfly(x):
    """Lane 0's result of ``warp_sum`` over the 32 lanes of x (32, ...):
    x_l += x_{l xor o} for o = 16, 8, 4, 2, 1."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = x + x[lanes ^ o]
    return x[0]


def _readout_emulated(e, x_hat, dist, w1, b1, w2, b2, offsets, cry,
                      n_crys, mma=mma_emulated):
    """Kernel 4 as it runs: h = silu of the split GEMM e W1 + b1, n = h .
    w2 + b2, the contributions n x_hat and n d x_hat ⊗ x_hat, each row's
    bonds summed in f32 in CSR order, row by row of each block of the
    launch's partition; then, for each crystal c, 256 threads walk every
    row, thread t rows t, t + 256, ... in order, summing the rows with
    bonds whose first bond is in c; a butterfly in each warp, the warps
    in order."""
    offs = offsets.long()
    n_real = int(offs[-1])
    h = torch.nn.functional.silu(mma(e[:n_real], w1) + b1)
    n = (h * w2[:, 0]).sum(dim=1) + b2
    xh = x_hat[:n_real]
    outer = (xh[:, :, None] * xh[:, None, :]).reshape(-1, 9)
    contrib = torch.cat([n[:, None] * xh,
                         (n * dist[:n_real])[:, None] * outer], dim=1)
    rows = torch.zeros(offs.shape[0] - 1, 12)
    plan = ops.conv_plan("force", e.shape[1], rows.shape[0], 132)
    for r_lo, r_hi, _, _ in ops.conv_chunks(offs, plan):
        for r in range(r_lo, r_hi):
            acc = torch.zeros(12)
            for t in range(int(offs[r]), int(offs[r + 1])):
                acc = acc + contrib[t]
            rows[r] = acc
    raw = torch.zeros(n_crys, 9)
    for c in range(n_crys):
        acc = torch.zeros(256, 9)
        for r in range(rows.shape[0]):
            if offs[r] < offs[r + 1] and int(cry[offs[r]]) == c:
                acc[r % 256] = acc[r % 256] + rows[r, 3:]
        warps = [_butterfly(acc[w * 32:(w + 1) * 32]) for w in range(8)]
        for w in warps:
            raw[c] = raw[c] + w
    return rows[:, :3], raw.reshape(-1, 3, 3)


@pytest.mark.parametrize("d", [16, 64])
def test_split_force_readouts_match_float64(d):
    """Kernels 4a and 4b emulated against the float64 plain versions: the
    forces of both, the per-crystal virial sums of 4b (zeros for the
    crystal without bonds and the empty slot)."""
    (e, x_hat, dist, w1, b1, w2, b2, seg, cry, offs, n_atoms,
     n_crys) = _readout_inputs(d)
    f64 = [t.double() for t in (e, x_hat, dist, w1, b1, w2, b2)]
    forces, raw = _readout_emulated(e, x_hat, dist, w1, b1, w2, b2, offs,
                                    cry, n_crys)
    want_f = ref.fused_force_readout_ref(f64[0], f64[1], *f64[3:], seg,
                                         offs, n_atoms)
    want_f2, want_raw = ref.fused_force_virial_readout_ref(
        *f64, seg, cry, offs, n_atoms, n_crys)
    assert _err(forces, want_f) <= TOL
    assert _err(forces, want_f2) <= TOL
    assert _err(raw, want_raw) <= TOL
    assert not raw[1].any() and not raw[3].any()
    plain = ref.fused_force_virial_readout_ref(
        e, x_hat, dist, w1, b1, w2, b2, seg, cry, offs, n_atoms, n_crys)
    assert _err(plain[0], want_f) <= TOL and _err(plain[1], want_raw) <= TOL


@pytest.mark.parametrize("layout", ["permuted", "interleaved"])
def test_split_crystal_sum_takes_any_slot_order(layout):
    """Kernel 4b emulated on crystal slots out of atom order (permuted,
    interleaved) against the float64 plain version, which sums bond by
    bond through ``bond_crystal``: the per-crystal sums do not depend on
    the order, zeros for the crystal without bonds and the empty slot."""
    (e, x_hat, dist, w1, b1, w2, b2, seg, cry, offs, n_atoms,
     n_crys) = _readout_inputs(16, 1, layout)
    f64 = [t.double() for t in (e, x_hat, dist, w1, b1, w2, b2)]
    _, raw = _readout_emulated(e, x_hat, dist, w1, b1, w2, b2, offs, cry,
                               n_crys)
    _, want = ref.fused_force_virial_readout_ref(*f64, seg, cry, offs,
                                                 n_atoms, n_crys)
    assert _err(raw, want) <= TOL
    assert not raw[1].any() and not raw[3].any()
    assert raw[0].any() and raw[2].any()


@pytest.mark.parametrize("mode", ["sym", "force"])
@pytest.mark.parametrize("dim", ops.CONV_WIDTHS)
def test_sym_and_force_plans_fit_the_card(mode, dim):
    """Kernel 5's and kernel 4's plans fit a block's 227 KB of shared
    memory and their blocks a SM the SM's 228 KB (1 KB reserved a block);
    both take 64-row tiles, one m16 tile a warp.  Kernel 5's K chunks
    cover the 3D columns of its folded W in order, each in one part."""
    plan = ops.conv_plan(mode, dim, 190_464, 132)
    assert plan.smem <= 232_448
    assert plan.blocks_per_sm * (plan.smem + 1024) <= 233_472
    assert plan.tm == plan.warps * 16 == 64
    if mode == "force":
        assert plan.k_chunks == 1
        assert plan.blocks_per_sm == (3 if dim <= 64 else 1)
        assert plan.grid == plan.blocks_per_sm * 132
        return
    assert plan.blocks_per_sm == 2
    assert plan.grid == 264
    kv, ke = min(dim, 32), min(dim, 16)
    cols = [(0, k, kv) for k in range(0, dim, kv)] \
        + [(1, dim + k, ke) for k in range(0, dim, ke)] \
        + [(2, 2 * dim + k, kv) for k in range(0, dim, kv)]
    assert len(cols) == plan.k_chunks
    pos = 0
    for part, k0, width in cols:
        assert k0 == pos and k0 // dim == part
        assert (k0 + width - 1) // dim == part  # one part a chunk
        pos = k0 + width
    assert pos == 3 * dim
    # a few rows: no more blocks than 64-row tiles
    assert ops.conv_plan("sym", dim, 65, 132).grid == 2


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_force_partition_owns_every_row_once(layout):
    """The force readouts' partition (``conv_chunks`` with their plan):
    the blocks' bond ranges are in order, disjoint and cover [0,
    offs[-1]); every atom row with bonds is owned by exactly one block,
    whole inside its range."""
    offs = _LAYOUTS[layout](np.random.default_rng(5)).astype(np.int64)
    n_rows, n_real = offs.shape[0] - 1, int(offs[-1])
    for grid in (1, 5, 396):
        plan = ops.conv_plan("force", CONV_D, n_rows, 132)._replace(
            grid=grid)
        chunks = ops.conv_chunks(torch.from_numpy(offs), plan)
        owner = np.full(n_rows, -1)
        pos = 0
        for c, (r_lo, r_hi, e_lo, e_hi) in enumerate(chunks):
            assert e_lo == pos and e_lo <= e_hi
            pos = e_hi
            for r in range(r_lo, r_hi):
                if offs[r + 1] > offs[r]:
                    assert owner[r] == -1
                    owner[r] = c
        assert pos == n_real
        assert ((owner >= 0) == (np.diff(offs) > 0)).all()


@pytest.mark.parametrize("d", [4, 24, 256])
@pytest.mark.parametrize("kernel", ["sym_msg", "force_readout",
                                    "force_virial"])
def test_readout_and_sym_kernels_refuse_widths_they_are_not_built_for(
        kernel, d):
    """Widths outside ``CONV_WIDTHS`` raise before any launch in kernel
    5's and kernel 4's CUDA paths (the wrappers never hand a CUDA tensor
    to the plain version)."""
    assert d not in ops.CONV_WIDTHS
    rng = np.random.default_rng(0)
    n, rows = 12, 3
    offs = torch.tensor([0, 5, 5, n], dtype=torch.int32)
    seg = torch.tensor([0] * 5 + [2] * 7, dtype=torch.int32)
    mlp = (_normal(rng, d, d), _normal(rng, d), _normal(rng, d, 1),
           _normal(rng, 1))
    with pytest.raises(ValueError, match="built for D in"):
        if kernel == "sym_msg":
            ops._sym_msg_cuda(
                _normal(rng, rows, d), _normal(rng, rows, d),
                _normal(rng, n, d), _normal(rng, rows, d),
                _normal(rng, 4 * d, 2 * d), _normal(rng, 2 * d),
                _normal(rng, 2 * d), _normal(rng, 2 * d), seg, seg, seg,
                torch.tensor([0, 2, 4, 6], dtype=torch.int32))
        elif kernel == "force_readout":
            ops._force_readout_cuda(_normal(rng, n, d), _normal(rng, n, 3),
                                    *mlp, seg, offs, rows)
        else:
            ops._force_virial_cuda(_normal(rng, n, d), _normal(rng, n, 3),
                                   _normal(rng, n), *mlp, seg, seg, offs,
                                   rows, 2)
    with pytest.raises(ValueError, match="built for D in"):
        ops.conv_plan("sym" if kernel == "sym_msg" else "force", d, rows,
                      132)
    assert ops.sym_msg.launches == 0
    assert ops.fused_force_readout.launches == 0
    assert ops.fused_force_virial_readout.launches == 0
