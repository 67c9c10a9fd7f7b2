"""Numerics of the split-f32 (3xTF32) products of the CUDA kernels 7
(GatedMLP, ``csrc/gated_mlp.cu``) and 11 (flash attention in f32,
``csrc/flash_attention.cu``), emulated on the CPU.

The kernels split each f32 operand x into TF32 parts hi = tf32(x) and lo =
tf32(x - hi) (``cvt.rna``: round to nearest, ties away from zero) and
accumulate, for every 8-wide step of the sum, a_lo b_hi, then a_hi b_lo,
then a_hi b_hi in f32 (``hopper.cuh`` ``mma_split``).  The emulation here
does the same with f32 matmuls of TF32 values (their products are exact in
f32) and is held to a float64 product through the GatedMLP's LayerNorms
and gate and through attention's softmax, within ``1e-5 * max(1,
max|ref|)``; one TF32 product per f32 product does not meet that bound,
which is why the kernels split.  The card holds the kernels themselves to
their plain versions (``chip_smoke.py``).
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
