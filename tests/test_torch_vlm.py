"""The port's qwen2-vl (M-RoPE through ``repro_torch.models.transformer``)
against ``repro.models`` on the CPU at the SMOKE size (2 layers, d 64,
head_dim 16, M-RoPE sections (4, 2, 2)): ``apply_mrope`` with distinct t /
h / w positions (at SMOKE's and the full config's sections), the
``forward_train`` logits on Qwen2-VL positions (text, a 2 x 4 image block
with t fixed and h, w over the grid, text), ``lm_loss`` and every
gradient leaf, prefill and decode with the cache, the ``serve.lm`` steps
(the MLP through the fused feed-forward wrapper), and
tests/test_models_smoke.py::test_mrope_norm_preserving and the decode
test mirrored.

Both packages get one parameter tree (the port's seeded ``decoder_init``
with every leaf moved by N(0, 0.05); as numpy arrays for JAX, the port's
copy through ``convert.lm_params_from_numpy``) and the same numpy
tokens.  Tolerance: f32 within ``1e-5 * max(1, max|jax|)``."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.serve import lm  # noqa: E402

ARCH = "qwen2-vl-2b"
B, S = 2, 16
# JAX's references compile with LLVM's expensive passes off, to cut
# compile time (as tests/test_torch_dp.py does)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _close(got, want, msg="", tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), (msg, err)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def vl_positions(b: int, n_text: int, grid: tuple[int, int], n_after: int):
    """Qwen2-VL's (t, h, w) positions for ``n_text`` text tokens, an image
    block of ``grid`` (h, w) patches at one t (h and w run over the grid
    from the block's start), then ``n_after`` text tokens continuing from
    the largest position + 1; (b, S, 3) int32."""
    text = np.repeat(np.arange(n_text)[:, None], 3, 1)
    gh, gw = grid
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    img = np.stack([np.zeros(gh * gw, int), hh.ravel(), ww.ravel()], 1)
    img += n_text
    start = img.max() + 1
    after = np.repeat(np.arange(start, start + n_after)[:, None], 3, 1)
    pos = np.concatenate([text, img, after]).astype(np.int32)
    return np.broadcast_to(pos, (b,) + pos.shape).copy()


@functools.cache
def _setup(seed=0):
    cfg = jax_smoke(ARCH)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda t: (t.numpy() + 0.05 * rng.standard_normal(t.shape))
        .astype(np.float32),
        tt.decoder_init(tconfigs.get_smoke(ARCH), seed, device="cpu"))
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, tree, tok, lab, vl_positions(B, 4, (2, 4), 4)


def test_positions_are_qwen2_vl_s():
    pos = vl_positions(1, 4, (2, 4), 4)[0]
    assert pos.shape == (16, 3)
    assert (pos[:4] == np.arange(4)[:, None]).all()
    assert (pos[4:12, 0] == 4).all()                # t fixed in the block
    assert pos[4:12, 1].tolist() == [4] * 4 + [5] * 4
    assert pos[4:12, 2].tolist() == [4, 5, 6, 7] * 2
    assert (pos[12:] == np.arange(8, 12)[:, None]).all()


@pytest.mark.parametrize("sections,head_dim", [((4, 2, 2), 16),
                                               ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, head_dim):
    """Distinct random t / h / w (a section split that was wrong would
    show), and equal to RoPE when t = h = w."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 8, 4, head_dim)).astype(np.float32)
    pos3 = rng.integers(0, 300, (2, 8, 3)).astype(np.int32)
    assert (pos3[..., 0] != pos3[..., 1]).any()
    got = tl.apply_mrope(_t(x), _t(pos3), sections, 1e6)
    _close(got, jl.apply_mrope(x, pos3, sections, 1e6))
    # mirror of test_mrope_norm_preserving
    np.testing.assert_allclose(np.linalg.norm(x, axis=-1),
                               np.linalg.norm(got.numpy(), axis=-1),
                               rtol=1e-4)
    same = np.repeat(pos3[..., :1], 3, -1)
    _close(tl.apply_mrope(_t(x), _t(same), sections, 1e6),
           tl.apply_rope(_t(x), _t(same[..., 0]), 1e6), "t = h = w")
    with pytest.raises(ValueError, match="sections"):
        tl.apply_mrope(_t(x), _t(pos3), (1, 1, 1), 1e6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_jax(use_pallas):
    cfg, tree, tok, _, pos = _setup()
    tcfg = tconfigs.get_smoke(ARCH)
    assert tapi.family_fns(tcfg).positions_3d
    got = tt.forward_train(tcfg, lm_params_from_numpy(tree), _t(tok),
                           _t(pos), use_pallas=use_pallas)
    _close(got, jt.forward_train(cfg, tree, tok, pos), "logits")


def test_lm_loss_and_grads_match_jax():
    cfg, tree, tok, lab, pos = _setup()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.lm_loss(cfg, p, tok, lab, pos)),
        compiler_options=FAST_COMPILE)(tree)
    params = lm_params_from_numpy(tree)
    flat = [p.requires_grad_() for p in leaves(params)]
    tcfg = tconfigs.get_smoke(ARCH)
    loss = tapi.family_fns(tcfg).loss(tcfg, params, _t(tok), _t(lab),
                                      _t(pos))
    _close(loss, jloss, "loss")
    grads = torch.autograd.grad(loss, flat)
    want = jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(g, w, f"grad leaf {i}")


def test_prefill_decode_and_serve_match_jax():
    """Prefill of the first 12 positions (text and the image block) into
    a 16-position f32 cache and decode of the last 4 (logits and cache);
    then ``serve.lm``'s greedy steps on the same prompt against the argmax
    of JAX's."""
    cfg, tree, tok, _, pos = _setup()
    tcfg = tconfigs.get_smoke(ARCH)
    params = lm_params_from_numpy(tree)
    jlog, jc = jt.prefill(cfg, tree, tok[:, :12], pos[:, :12], max_len=S,
                          chunk=4, cache_dtype=jnp.float32)
    with torch.no_grad():
        log, c = tt.prefill(tcfg, params, _t(tok[:, :12]), _t(pos[:, :12]),
                            S, chunk=4, cache_dtype=torch.float32)
    _close(log, jlog, "prefill")
    step = jax.jit(lambda p, t, c_, q: jt.decode_step(cfg, p, t, c_, q),
                   compiler_options=FAST_COMPILE)
    for i in range(12, 14):
        jlog, jc = step(tree, tok[:, i:i + 1], jc, pos[:, i:i + 1])
        with torch.no_grad():
            log, c = tt.decode_step(tcfg, params, _t(tok[:, i:i + 1]), c,
                                    _t(pos[:, i:i + 1]))
        _close(log, jlog, f"decode {i}")
    for k in ("k", "v"):
        _close(c[k], jc[k], k)

    sp = lm.load_serving_params(lm_params_from_numpy(tree), tcfg, "cpu",
                                serve_dtype="float32")
    nxt, cache = lm.prefill_step(tcfg, sp, _t(tok[:, :12]), _t(pos[:, :12]),
                                 S)
    jlog, jc = jt.prefill(cfg, tree, tok[:, :12], pos[:, :12], max_len=S)
    jtok = jnp.argmax(jlog[:, -1:], -1)
    assert nxt.tolist() == np.asarray(jtok[:, 0]).tolist()
    tok_t = nxt[:, None]
    for i in range(12, 14):
        tok_t, cache = lm.decode_step(tcfg, sp, tok_t, cache,
                                      _t(pos[:, i:i + 1]))
        jlog, jc = step(tree, jtok, jc, pos[:, i:i + 1])
        jtok = jnp.argmax(jlog, -1)
        assert tok_t.tolist() == np.asarray(jtok).tolist()


def test_vlm_decode_matches_forward():
    """The port's prefill + decode against its forward over the same
    tokens, as tests/test_models_smoke.py's decode tests, on Qwen2-VL
    positions."""
    cfg = tconfigs.get_smoke(ARCH)
    params = tt.decoder_init(cfg, 0, device="cpu")
    tok = _t(np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S)))
    pos = _t(vl_positions(B, 4, (2, 4), 4))
    with torch.no_grad():
        full = tt.forward_train(cfg, params, tok, pos)
        _, cache = tt.prefill(cfg, params, tok[:, :6], pos[:, :6], S,
                              chunk=3, cache_dtype=torch.float32)
        errs = []
        for i in range(6, S):
            lg, cache = tt.decode_step(cfg, params, tok[:, i:i + 1], cache,
                                       pos[:, i:i + 1])
            errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 1e-4
