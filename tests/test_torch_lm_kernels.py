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


@pytest.mark.parametrize("m,itemsize,want", [
    # llama3-8b prefill, 4 x 512 tokens: 8 chunks per group (shared-memory
    # cap), 14 groups, one launch (14 * 2048 * 4096 f32 = 448 MiB)
    (2048, 2, (8, 14, 2048)),
    # decode at batch 4: one chunk per group, 112 blocks side by side
    (4, 2, (1, 112, 4)),
    # f32 caps the group at 5 chunks
    (2048, 4, (5, 23, 1408)),
    # a long prompt goes through in slabs of rows
    (32768, 2, (8, 14, 2304)),
])
def test_swiglu_plan(m, itemsize, want):
    assert tops.swiglu_plan(m, 4096, 14336, itemsize, 132) == want
