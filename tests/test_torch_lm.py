"""The port's dense LM substrate (``repro_torch.models``, ``serve.lm``)
against ``repro.models`` on the CPU at the SMOKE sizes: the layers, the
logits of ``forward_train`` for llama3-8b, gemma-2b, qwen3-8b and
qwen1.5-110b, prefill and decode, the weight bridge and the configs (the
MoE family is in tests/test_torch_moe.py, training in
tests/test_torch_lm_train.py).

Both packages get one parameter tree (JAX's ``decoder_init``, through
``convert.lm_params_from_numpy``) and one set of numpy tokens.  Tolerances:
f32 at 1e-5 relative to the largest output; bf16 at DESIGN.md §4's bound,
3e-2 of the largest output and a cosine of 0.999 (bf16 rounds at other
places in the two frameworks' matmuls; the fused MLP also sums its F
blocks in f32 where the Pallas kernel sums them in bf16).  ``use_pallas``
runs the fused feed-forward (the port's plain version here, the Pallas
kernel in interpret mode in JAX) at ``d_ff = 256``: the Pallas wrapper
asserts F % 256 == 0, and the SMOKE configs have 160."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import _to_numpy  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serve import lm  # noqa: E402

DENSE = ["llama3-8b", "gemma-2b", "qwen3-8b", "qwen1.5-110b"]
PORTED = DENSE + ["phi3.5-moe-42b-a6.6b", "deepseek-moe-16b"]


def _np(a):
    return np.asarray(a, np.float32)


def _f32(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 1e-5 * max(1.0, np.abs(want).max()), err


def _bf16(got, want):
    got, want = _np(got).ravel(), _np(want).ravel()
    err = np.abs(got - want).max()
    assert err <= 3e-2 * max(1.0, np.abs(want).max()), err
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos >= 0.999, cos


def _same(jax_cfg, port_cfg) -> bool:
    """One configuration in the two packages' copies of ``LMConfig``."""
    return dataclasses.asdict(jax_cfg) == dataclasses.asdict(port_cfg)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _tokens(cfg, b, s, seed=0):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    return tok.astype(np.int32), pos.astype(np.int32)


def _trees(cfg, seed=0):
    """The JAX tree and the port's copy of it (f32 on the CPU)."""
    params = jt.decoder_init(cfg, jax.random.PRNGKey(seed))
    return params, lm_params_from_numpy(jax.tree.map(np.asarray, params))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, s = rng.normal(0, 2, (3, 5, 64)), rng.uniform(0.5, 1.5, 64)
    _f32(tl.rms_norm(_t(x), _t(s)), jl.rms_norm(jnp.asarray(x, jnp.float32),
                                                jnp.asarray(s, jnp.float32)))
    got = tl.rms_norm(_t(x, torch.bfloat16), _t(s, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _bf16(got.float(), jl.rms_norm(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(s, jnp.bfloat16)))


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 9, 4, 32))
    pos = rng.integers(0, 40, (2, 9)).astype(np.int32)
    _f32(tl.apply_rope(_t(x), torch.from_numpy(pos), theta),
         jl.apply_rope(jnp.asarray(x, jnp.float32), jnp.asarray(pos), theta))


def _gqa(seed, b, sq, sk, h, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, sq, h, d)), rng.normal(0, 1, (b, sk, hkv, d)),
            rng.normal(0, 1, (b, sk, hkv, d)))


@pytest.mark.parametrize("case", ["causal", "offset", "kv_len", "plain"])
def test_attention_full_matches_jax(case):
    q, k, v = _gqa(2, 2, 6, 10, 4, 2, 16)
    kw = {"causal": case != "plain"}
    if case == "offset":
        kw["q_offset"] = 4
    jkw = dict(kw)
    if case == "kv_len":
        kw["kv_len"] = torch.tensor([3, 10])
        jkw["kv_len"] = jnp.asarray([3, 10])
    _f32(tl.attention_full(_t(q), _t(k), _t(v), **kw),
         jl.attention_full(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)),
                           **jkw))


def test_attention_decode_merge_matches_jax():
    rng = np.random.default_rng(3)
    q, kc, vc = _gqa(3, 2, 1, 12, 4, 2, 16)
    kn, vn = rng.normal(0, 1, (2, 2, 1, 2, 16))
    args = (q, kc, vc, kn, vn)
    _f32(tl.attention_decode_merge(*(_t(a) for a in args), 7),
         jl.attention_decode_merge(*(jnp.asarray(a, jnp.float32)
                                     for a in args), jnp.int32(7)))


@pytest.mark.parametrize("chunk", [4, 5])
def test_attention_chunked_matches_jax(chunk):
    """chunk 4 splits 12 query rows in three; 5 falls back to full."""
    q, k, v = _gqa(4, 2, 12, 12, 4, 1, 16)
    _f32(tl.attention_chunked(_t(q), _t(k), _t(v), causal=True, chunk=chunk),
         jl.attention_chunked(*(jnp.asarray(a, jnp.float32)
                                for a in (q, k, v)), causal=True,
                              chunk=chunk))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_matches_jax(arch, use_pallas, dtype):
    cfg = jax_smoke(arch).with_(compute_dtype=dtype)
    tcfg = tconfigs.get_smoke(arch).with_(compute_dtype=dtype)
    if use_pallas:
        cfg, tcfg = cfg.with_(d_ff=256), tcfg.with_(d_ff=256)
    assert _same(cfg, tcfg)
    params, tree = _trees(cfg)
    tok, pos = _tokens(cfg, 2, 12)
    want = jt.forward_train(cfg, params, jnp.asarray(tok), jnp.asarray(pos),
                            use_pallas=use_pallas)
    got = tt.forward_train(
        tcfg, lm.load_serving_params(tree, tcfg, "cpu", serve_dtype=dtype),
        torch.from_numpy(tok), torch.from_numpy(pos), use_pallas=use_pallas)
    assert got.dtype == getattr(torch, dtype)
    (_f32 if dtype == "float32" else _bf16)(got.float(), want)


def test_decode_matches_forward():
    """Mirror of tests/test_models_smoke.py::
    test_transformer_decode_matches_forward: prefill 6 tokens with chunk 3,
    decode 6 more with an f32 cache; each step's logits against the
    full-sequence logits, in the port, and against JAX's decode."""
    cfg = jax_smoke("qwen3-8b")
    tcfg = tconfigs.get_smoke("qwen3-8b")
    params, tree = _trees(cfg)
    tok, pos = _tokens(cfg, 2, 12)
    ttok, tpos = torch.from_numpy(tok), torch.from_numpy(pos)
    full = tt.forward_train(tcfg, tree, ttok, tpos)
    lg, cache = tt.prefill(tcfg, tree, ttok[:, :6], tpos[:, :6], max_len=12,
                           chunk=3, cache_dtype=torch.float32)
    jlg, jcache = jt.prefill(cfg, params, jnp.asarray(tok[:, :6]),
                             jnp.asarray(pos[:, :6]), max_len=12, chunk=3,
                             cache_dtype=jnp.float32)
    _f32(lg, jlg)
    _f32(cache["k"], jcache["k"])
    _f32(cache["v"], jcache["v"])
    assert cache["pos"] == int(jcache["pos"]) == 6
    errs = []
    for i in range(6, 12):
        lg, cache = tt.decode_step(tcfg, tree, ttok[:, i:i + 1], cache,
                                   tpos[:, i:i + 1])
        jlg, jcache = jt.decode_step(cfg, params, jnp.asarray(tok[:, i:i + 1]),
                                     jcache, jnp.asarray(pos[:, i:i + 1]))
        _f32(lg, jlg)
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 1e-4
    _f32(cache["k"], jcache["k"])
    assert cache["pos"] == 12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_steps_match_jax(dtype):
    """Greedy serving at llama3-8b's SMOKE size with the fused MLP: the
    port's prefill and decode logits against JAX's, teacher-forced on
    JAX's greedy tokens (a near-tie in an argmax cannot make the two
    diverge), and ``prefill_step`` / ``decode_step``'s tokens against the
    argmax of the port's own logits."""
    cfg = jax_smoke("llama3-8b").with_(d_ff=256, compute_dtype=dtype)
    tcfg = tconfigs.get_smoke("llama3-8b").with_(d_ff=256,
                                                 compute_dtype=dtype)
    params, tree = _trees(cfg, seed=3)
    tparams = lm.load_serving_params(tree, tcfg, "cpu", serve_dtype=dtype)
    close = _f32 if dtype == "float32" else _bf16
    tok, pos = _tokens(cfg, 3, 8, seed=5)
    ttok, tpos = torch.from_numpy(tok), torch.from_numpy(pos)
    jlg, jcache = jt.prefill(cfg, params, jnp.asarray(tok), jnp.asarray(pos),
                             12, use_pallas=True)
    with torch.inference_mode():
        tlg, tcache = tt.prefill(tcfg, tparams, ttok, tpos, 12,
                                 use_pallas=True)
    close(tlg.float(), jlg)
    nxt, cache = lm.prefill_step(tcfg, tparams, ttok, tpos, 12)
    assert nxt.shape == (3,) and cache["k"].shape[2] == 12
    assert torch.equal(nxt, tlg[:, -1].argmax(-1))
    for step in range(3):
        forced = np.array(jnp.argmax(jlg[:, -1], -1), np.int32)[:, None]
        p = np.full((3, 1), 8 + step, np.int32)
        jlg, jcache = jt.decode_step(cfg, params, jnp.asarray(forced),
                                     jcache, jnp.asarray(p), use_pallas=True)
        with torch.inference_mode():
            tlg, tcache = tt.decode_step(tcfg, tparams,
                                         torch.from_numpy(forced), tcache,
                                         torch.from_numpy(p),
                                         use_pallas=True)
        close(tlg.float(), jlg)
        nxt, cache = lm.decode_step(tcfg, tparams, torch.from_numpy(forced),
                                    cache, torch.from_numpy(p))
        assert torch.equal(nxt, tlg.argmax(-1))
        assert cache["pos"] == 9 + step


def test_params_must_be_in_compute_dtype():
    cfg = tconfigs.get_smoke("llama3-8b")
    tree = tt.decoder_init(cfg, 0, device="cpu", dtype=torch.bfloat16)
    tok = torch.zeros((1, 3), dtype=torch.long)
    with pytest.raises(TypeError, match="load_serving_params"):
        tt.forward_train(cfg, tree, tok, tok)


def test_decoder_init_layout_matches_jax():
    """The port's seeded init has the JAX tree's structure, shapes and
    scales (not its numbers)."""
    for arch in DENSE:
        cfg = jax_smoke(arch)
        _, want = _trees(cfg)
        got = tt.decoder_init(tconfigs.get_smoke(arch), 7, device="cpu")

        def flat(t, pre=""):
            for k, v in t.items():
                if isinstance(v, dict):
                    yield from flat(v, pre + k + "/")
                else:
                    yield pre + k, v
        gw, ww = dict(flat(got)), dict(flat(want))
        assert gw.keys() == ww.keys(), arch
        for k in gw:
            assert gw[k].shape == ww[k].shape and gw[k].dtype == ww[k].dtype
            if gw[k].numel() > 1000:
                ratio = float(gw[k].std() / ww[k].std())
                assert 0.9 < ratio < 1.1, (arch, k, ratio)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_lm_params_from_numpy_round_trips(dtype):
    params = jt.decoder_init(jax_smoke("gemma-2b"), jax.random.PRNGKey(2))
    src = jax.tree.map(lambda a: np.asarray(a.astype(dtype)), params)
    tree = lm_params_from_numpy(src)
    assert tree.keys() == src.keys()
    for k, v in tree["layers"]["attn"].items():
        s = src["layers"]["attn"][k]
        assert tuple(v.shape) == s.shape
    pairs = zip(jax.tree.leaves(src),
                jax.tree.leaves(tree, is_leaf=torch.is_tensor))
    for s, t in pairs:
        if dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  s.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), s)
        s_copy = s.copy()
        t.zero_()
        assert np.array_equal(s, s_copy)  # a copy, not a view


# ---------------------------------------------------------------------------
# configs, registry, devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_matches_assignment(arch):
    cfg = tconfigs.get_config(arch)
    expected = {
        "llama3-8b": (32, 4096, 32, 8, 14336, 128256),
        "gemma-2b": (18, 2048, 8, 1, 16384, 256000),
        "qwen3-8b": (36, 4096, 32, 8, 12288, 151936),
        "qwen1.5-110b": (80, 8192, 64, 8, 49152, 152064),
        "phi3.5-moe-42b-a6.6b": (32, 4096, 32, 8, 6400, 32064),
        "deepseek-moe-16b": (28, 2048, 16, 16, 1408, 102400),
        "whisper-medium": (24, 1024, 16, 16, 4096, 51865),
        "qwen2-vl-2b": (28, 1536, 12, 2, 8960, 151936),
        "zamba2-1.2b": (38, 2048, 32, 32, 8192, 32000),
        "rwkv6-3b": (32, 2560, 40, 40, 8960, 65536),
    }[arch]
    got = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.moe.d_ff_expert if cfg.is_moe else cfg.d_ff, cfg.vocab_size)
    assert got == expected
    assert _same(jax_config(arch), cfg)
    assert _same(jax_smoke(arch), tconfigs.get_smoke(arch))


def test_llama3_8b_serving_size():
    cfg = tconfigs.get_config("llama3-8b")
    assert cfg.activation == "silu" and cfg.rope_theta == 5e5
    assert cfg.resolved_head_dim == 128
    assert cfg.param_count() == 8_029_995_008


def test_other_archs_raise():
    """Every id of JAX's registry resolves (the four families of
    qwen2-vl, zamba2, rwkv6 and whisper included), its CONFIG and SMOKE
    equal JAX's field by field, and ``family_fns`` has a bundle with
    JAX's flags for each; an unknown id or family still raises."""
    from repro.models.api import family_fns as jax_family_fns

    assert tconfigs.ARCH_IDS == ARCH_IDS
    for arch in ARCH_IDS:
        assert _same(jax_config(arch), tconfigs.get_config(arch)), arch
        assert _same(jax_smoke(arch), tconfigs.get_smoke(arch)), arch
        cfg = tconfigs.get_smoke(arch)
        fns, jfns = tapi.family_fns(cfg), jax_family_fns(jax_smoke(arch))
        for flag in ("has_positions", "positions_3d", "token_input",
                     "supports_long_context"):
            assert getattr(fns, flag) == getattr(jfns, flag), (arch, flag)
    assert tapi.family_fns(tconfigs.get_smoke("qwen2-vl-2b")).positions_3d
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-5")
    with pytest.raises(ValueError, match="unknown family"):
        tapi.family_fns(tconfigs.get_smoke("gemma-2b").with_(family="cnn"))
    fns = tapi.family_fns(tconfigs.get_smoke("gemma-2b"))
    assert fns.forward is tt.forward_train and fns.has_positions


def test_load_serving_params_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke("llama3-8b")
    tree = tt.decoder_init(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.load_serving_params(tree, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.decoder_init(cfg, 0)
    out = lm.load_serving_params(tree, cfg, "cpu")
    assert out["layers"]["mlp"]["wg"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "zamba2-1.2b", "rwkv6-3b",
                                  "whisper-medium"])
def test_lm_params_from_numpy_carries_new_families(arch):
    """The weight bridge carries the trees of item 14d's families (the
    VLM decoder, the hybrid's ``layers`` + ``shared``, rwkv's ``layers``,
    whisper's ``encoder`` / ``decoder``) bit for bit, f32 and bf16."""
    cfg = tconfigs.get_smoke(arch)
    tree = tapi.family_fns(cfg).init(cfg, 0, device="cpu")
    for dtype in (torch.float32, torch.bfloat16):
        src = jax.tree.map(lambda t, d=dtype: _to_numpy(t.to(d)), tree)
        got = lm_params_from_numpy(src)
        assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
            jax.tree.structure(jax.tree.map(lambda a: 0, src))
        for t, a in zip(jax.tree.leaves(got), jax.tree.leaves(src)):
            assert t.dtype == dtype and tuple(t.shape) == a.shape
            assert np.array_equal(_to_numpy(t).view(np.uint8),
                                  np.asarray(a).view(np.uint8))
