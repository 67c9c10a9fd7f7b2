"""The port's LM kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode: the fused
gated feed-forward (kernel 10) and flash attention (kernel 11).  Inputs
are made from a seed with numpy and handed to both.

Tolerances: f32 at 1e-5 relative for the feed-forward (both accumulate in
f32) and at ``tests/test_kernels.py``'s 2e-4 for attention; in bf16 the
feed-forward is held to DESIGN.md §4's bound (3e-2 of the largest output
and a cosine of 0.999: the Pallas kernel sums its F blocks in bf16, the
port in f32) and attention to ``test_kernels.py``'s 5e-2.  The CUDA
kernels run only on the card (chip_smoke.py holds them against these
plain versions); here the wrappers launch nothing."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

D = 64


def _np(a):
    return np.asarray(a, np.float32)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _close_bf16(got, want):
    """DESIGN.md §4: max error within 3e-2 of the largest |want| (or 1),
    cosine similarity at least 0.999."""
    got, want = _np(got).ravel(), _np(want).ravel()
    err = np.abs(got - want).max()
    assert err <= 3e-2 * max(1.0, np.abs(want).max()), err
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos >= 0.999, cos


def _mlp(seed, m, f, d=D):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (m, d)), rng.normal(0, d ** -0.5, (d, f)),
            rng.normal(0, d ** -0.5, (d, f)), rng.normal(0, f ** -0.5, (f, d)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("m", [1, 7, 128])
@pytest.mark.parametrize("f", [256, 512])
def test_fused_swiglu_f32_matches_pallas(act, m, f):
    arrs = _mlp(m * 1000 + f, m, f)
    got = tops.fused_swiglu(*(_t(a, torch.float32) for a in arrs),
                            activation=act)
    want = jops.fused_swiglu(*(_j(a, jnp.float32) for a in arrs),
                             activation=act)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("m", [1, 7, 128])
def test_fused_swiglu_bf16_matches_pallas(act, m):
    arrs = _mlp(m + 17, m, 512)
    got = tops.fused_swiglu(*(_t(a, torch.bfloat16) for a in arrs),
                            activation=act)
    assert got.dtype == torch.bfloat16
    want = jops.fused_swiglu(*(_j(a, jnp.bfloat16) for a in arrs),
                             activation=act)
    _close_bf16(got.float(), want)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_fused_swiglu_ragged_f(act):
    """F = 160 (the SMOKE configs' d_ff), which the Pallas wrapper refuses:
    the port takes it, and agrees with the jnp expression of the MLP."""
    arrs = _mlp(3, 9, 160)
    got = tops.fused_swiglu(*(_t(a, torch.float32) for a in arrs),
                            activation=act)
    x, wg, wu, wd = (_j(a, jnp.float32) for a in arrs)
    if act == "silu":
        want = jref.fused_swiglu_ref(x, wg, wu, wd)
    else:
        want = (jax.nn.gelu(x @ wg, approximate=True) * (x @ wu)) @ wd
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    plain = tref.fused_swiglu_ref(*(_t(a, torch.float32) for a in arrs), act)
    assert torch.equal(got, plain)


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h, sq, d)), rng.normal(0, 1, (b, h, sk, d)),
            rng.normal(0, 1, (b, h, sk, d)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,s,d", [(1, 2, 256, 64), (2, 4, 128, 128)])
def test_flash_attention_f32_matches_pallas(causal, b, h, s, d):
    arrs = _qkv(s + d, b, h, s, s, d)
    got = tops.flash_attention(*(_t(a, torch.float32) for a in arrs),
                               causal=causal)
    want = jops.flash_attention(*(_j(a, jnp.float32) for a in arrs),
                                causal=causal)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_matches_pallas(causal):
    arrs = _qkv(5, 1, 2, 128, 128, 64)
    got = tops.flash_attention(*(_t(a, torch.bfloat16) for a in arrs),
                               causal=causal)
    assert got.dtype == torch.bfloat16
    want = jops.flash_attention(*(_j(a, jnp.bfloat16) for a in arrs),
                                causal=causal)
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=5e-2,
                               atol=5e-2)


def test_flash_attention_causal_is_top_left():
    """Sq < Sk: the Pallas kernel keeps columns j <= i from the top-left
    corner (its jnp oracle would keep j <= i + Sk - Sq); the port follows
    the kernel."""
    arrs = _qkv(11, 1, 2, 128, 256, 64)
    got = tops.flash_attention(*(_t(a, torch.float32) for a in arrs),
                               causal=True)
    want = jops.flash_attention(*(_j(a, jnp.float32) for a in arrs),
                                causal=True)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-4, atol=2e-4)
    bottom_right = jref.flash_attention_ref(
        *(_j(a, jnp.float32) for a in arrs), causal=True)
    assert np.abs(got.numpy() - _np(bottom_right)).max() > 1e-2


def test_flash_attention_ragged_s_matches_oracle():
    """S = 77 (the Pallas wrapper asserts multiples of 128): the port's
    plain version against the jnp oracle, whose convention agrees with
    the kernel's when Sq == Sk."""
    arrs = _qkv(13, 2, 3, 77, 77, 64)
    got = tops.flash_attention(*(_t(a, torch.float32) for a in arrs),
                               causal=True)
    want = jref.flash_attention_ref(*(_j(a, jnp.float32) for a in arrs),
                                    causal=True)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-4, atol=2e-4)


def test_lm_wrappers_launch_nothing_on_cpu():
    tops.reset_launch_counts()
    arrs = _mlp(0, 4, 160)
    tops.fused_swiglu(*(_t(a, torch.bfloat16) for a in arrs))
    tops.flash_attention(*(_t(a, torch.float32)
                           for a in _qkv(0, 1, 1, 5, 5, 64)))
    counts = tops.launch_counts()
    assert counts["fused_swiglu"] == 0 and counts["flash_attention"] == 0
    assert not any(counts.values())


def test_lm_wrappers_check_their_operands():
    x, wg, wu, wd = (_t(a, torch.float32) for a in _mlp(1, 4, 160))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tops.fused_swiglu(x.half(), wg.half(), wu.half(), wd.half())
    with pytest.raises(TypeError, match="expected torch.float32"):
        tops.fused_swiglu(x, wg.bfloat16(), wu, wd)
    with pytest.raises(ValueError, match="w_down"):
        tops.fused_swiglu(x, wg, wu, wd[:-1])
    with pytest.raises(ValueError, match="activation"):
        tops.fused_swiglu(x, wg, wu, wd, activation="relu")
    with pytest.raises(RuntimeError, match="no backward"):
        tops.fused_swiglu(x.requires_grad_(), wg, wu, wd)
    q, k, v = (_t(a, torch.float32) for a in _qkv(2, 1, 2, 4, 6, 64))
    with pytest.raises(ValueError, match="v has shape"):
        tops.flash_attention(q, k, v[:, :, :5])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tops.flash_attention(q.double(), k.double(), v.double())


SMS = 132  # the H100's SMs


@pytest.mark.parametrize("m,f,itemsize,want", [
    # llama3-8b prefill, 4 x 512 tokens: the wide wgmma schedule, 16 x 112
    # gate/up tiles, 16 x 16 down tiles (>= 132, no split), h 59 MB
    (2048, 14336, 2, dict(wide=True, producer="tma", rows=128,
                          gate_cols=128, down_cols=256, gate_blocks=1792,
                          down_blocks=256, splits=1, stages=4)),
    # decode at batch 4: the narrow schedule; Wd streamed by 64 D tiles x 5
    # K slices = 320 >= 2 x 132 blocks
    (4, 14336, 2, dict(wide=False, producer="tma", rows=64, gate_cols=64,
                       down_cols=64, gate_blocks=224, down_blocks=320,
                       splits=5, k_split=2880)),
    # f32: split f32 on mma.sync, 128-row tiles, 64-column gate/up and
    # 128-column down tiles, a 3-stage ring of K 64 (210 KB)
    (2048, 14336, 4, dict(wide=True, producer="cp.async", rows=128,
                          gate_cols=64, down_cols=128, gate_blocks=3584,
                          down_blocks=512, splits=1, stages=3,
                          smem_gate=215040, smem_down=211968)),
    # f32 at M 128 (the timed case): one row tile, 224 gate/up blocks for
    # the 132 SMs; 32 down tiles x 8 K slices of 1,792 rows, two waves of
    # one block an SM
    (128, 14336, 4, dict(wide=True, rows=128, gate_cols=64, gate_blocks=224,
                         down_blocks=256, splits=8, k_split=1792)),
    # f32 decode: 16-row tiles; 64 down tiles x 4 K slices; a 4-stage
    # ring of K 32 (78 KB: two blocks an SM)
    (4, 14336, 4, dict(wide=False, rows=16, gate_cols=64, down_cols=64,
                       gate_blocks=224, down_blocks=256, splits=4,
                       k_split=3584, stages=4, smem_gate=79872)),
    # F = 1001 rows are not 16-byte aligned: the element-wise producer; 4
    # down tiles, so K splits into 16 slices of one 64-row stage
    (130, 1001, 2, dict(wide=True, producer="elementwise", splits=16,
                        k_split=64, down_blocks=64)),
    # a 32,768-token prompt runs in one launch (no slabs): 256 x 112 tiles
    (32768, 14336, 2, dict(wide=True, gate_blocks=28672, down_blocks=4096,
                           splits=1)),
])
def test_swiglu_plan(m, f, itemsize, want):
    d = 512 if f == 1001 else 4096
    plan = tops.swiglu_plan(m, d, f, itemsize, SMS)
    got = dict(plan._asdict(), gate_blocks=plan.gate_blocks,
               down_blocks=plan.down_blocks)
    assert {k: got[k] for k in want} == want
    # scratch: h (M, F) in the operand type, plus the f32 split partials
    partials = plan.splits * m * d * 4 if plan.splits > 1 else 0
    assert plan.scratch_bytes == m * f * itemsize + partials
    if m <= 64 and itemsize == 2:
        assert plan.down_blocks >= 2 * SMS
    if itemsize == 4 and m <= 256:
        # every SM gets a gate/up block, and split-K fills the down
        # product's two waves of one block an SM
        assert plan.gate_blocks >= SMS
        assert SMS < plan.down_blocks <= 2 * SMS


@pytest.mark.parametrize("m,d,f,itemsize", [
    (1, 4096, 14336, 2), (4, 4096, 14336, 2), (16, 4096, 14336, 2),
    (64, 4096, 14336, 2), (65, 4096, 14336, 2), (129, 4096, 14336, 2),
    (2048, 4096, 14336, 2), (2341, 4096, 14336, 2), (128, 4096, 14336, 4),
    (37, 512, 1000, 2), (130, 512, 1001, 2), (200, 100, 160, 4),
    (65, 99, 160, 4), (4, 4096, 14336, 4), (16, 4096, 14336, 4),
    (17, 4096, 14336, 4), (256, 4096, 14336, 4), (37, 64, 1000, 4),
])
def test_swiglu_plan_covers_every_tile_once(m, d, f, itemsize):
    """Blocks (x, y[, z]) of csrc/swiglu.cu own rows [x rows, +rows), the
    gate/up product's F columns [y gate_cols, +gate_cols), the down
    product's D columns [y down_cols, +down_cols) and its K = F rows [z
    k_split, +k_split), each cut at the edge: every output element of both
    GEMMs is owned by exactly one block (per K slice), the K slices cover F
    exactly once, and each block's shared memory fits the card's."""
    plan = tops.swiglu_plan(m, d, f, itemsize, SMS)
    r, gc, dc, ks = plan.rows, plan.gate_cols, plan.down_cols, plan.k_split
    gate = np.zeros((m, f), np.uint8)
    for x in range(plan.row_tiles):
        for y in range(plan.gate_tiles):
            gate[x * r:(x + 1) * r, y * gc:(y + 1) * gc] += 1
    assert (gate == 1).all()
    down = np.zeros((m, d), np.uint8)
    for x in range(plan.row_tiles):
        for y in range(plan.down_tiles):
            down[x * r:(x + 1) * r, y * dc:(y + 1) * dc] += 1
    assert (down == 1).all()
    k = np.zeros(f, np.uint8)
    for z in range(plan.splits):
        assert z * ks < f
        k[z * ks:(z + 1) * ks] += 1
    assert (k == 1).all() and ks % 64 == 0
    assert plan.gate_blocks == plan.row_tiles * plan.gate_tiles
    assert plan.down_blocks == plan.row_tiles * plan.down_tiles * plan.splits
    assert max(plan.smem_gate, plan.smem_down) <= 232448
