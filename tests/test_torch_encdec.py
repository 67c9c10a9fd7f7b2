"""The port's whisper encoder-decoder (``repro_torch.models.encdec``)
against ``repro.models.encdec`` on the CPU at the SMOKE size (2 + 2
layers, d 64, 4 heads): ``sinusoid_pos``, the plain tanh-GELU MLP,
``encode``, ``forward_train``, ``lm_loss`` (labels shifted right with a 0)
and every gradient leaf, ``init_cache`` and the decode steps with their
caches, the ``serve.lm`` steps (prefill = ``encode`` + ``init_cache``,
JAX's placeholder readout: token 0), the init layout, and
tests/test_models_smoke.py::test_whisper_decode_matches_forward mirrored.

Both packages get one parameter tree (the port's seeded ``whisper_init``
with every leaf moved by N(0, 0.05), so that the zero-initialised MLP
biases take part; as numpy arrays for JAX, the port's copy through
``convert.lm_params_from_numpy``), the same numpy frames and tokens.
Tolerance: f32 within ``1e-5 * max(1, max|jax|)``."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import encdec as je  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import encdec as te  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.serve import lm  # noqa: E402

ARCH = "whisper-medium"
B, SE, SD = 2, 20, 8
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


@functools.cache
def _setup(seed=0):
    cfg = jax_smoke(ARCH)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda t: (t.numpy() + 0.05 * rng.standard_normal(t.shape))
        .astype(np.float32),
        te.whisper_init(tconfigs.get_smoke(ARCH), seed, device="cpu"))
    frames = rng.normal(0, 1, (B, SE, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, (B, SD)).astype(np.int32)
    return cfg, tree, frames, tok


def test_init_layout_and_sinusoid_match_jax():
    cfg = jax_smoke(ARCH)
    want = jax.eval_shape(lambda: je.whisper_init(cfg,
                                                  jax.random.PRNGKey(0)))
    mine = te.whisper_init(tconfigs.get_smoke(ARCH), 0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda w: 0, want))
    for t, w in zip(leaves(mine), jax.tree.leaves(want)):
        assert tuple(t.shape) == w.shape and t.dtype == torch.float32
    for s, d in ((1, 64), (20, 64)):
        _close(te.sinusoid_pos(s, d), je.sinusoid_pos(s, d), f"{s} x {d}")
    # whisper's full decoder table: the two frameworks' f32 exp of a
    # frequency differ by an ulp in places, which the angle multiplies by
    # the position (measured gap 3.05e-5 at position 434)
    _close(te.sinusoid_pos(448, 1024), je.sinusoid_pos(448, 1024),
           "448 x 1024", 1e-4)


def test_plain_mlp_matches_jax():
    _, tree, frames, _ = _setup()
    mlp = jax.tree.map(lambda a: a[0], tree["encoder"]["mlp"])
    got = tl.plain_mlp_apply(lm_params_from_numpy(mlp), _t(frames))
    _close(got, jl.plain_mlp_apply(mlp, frames))


def test_encode_and_forward_match_jax():
    cfg, tree, frames, tok = _setup()
    tcfg = tconfigs.get_smoke(ARCH)
    params = lm_params_from_numpy(tree)
    _close(te.encode(tcfg, params, _t(frames)),
           je.encode(cfg, tree, frames), "encoder output")
    _close(tapi.family_fns(tcfg).forward(tcfg, params, _t(frames), _t(tok)),
           je.forward_train(cfg, tree, frames, tok), "logits")


def test_lm_loss_and_grads_match_jax():
    cfg, tree, frames, tok = _setup()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: je.lm_loss(cfg, p, frames, tok)),
        compiler_options=FAST_COMPILE)(tree)
    params = lm_params_from_numpy(tree)
    flat = [p.requires_grad_() for p in leaves(params)]
    tcfg = tconfigs.get_smoke(ARCH)
    loss = tapi.family_fns(tcfg).loss(tcfg, params, _t(frames), _t(tok))
    _close(loss, jloss, "loss")
    grads = torch.autograd.grad(loss, flat)
    want = jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(g, w, f"grad leaf {i}")


def test_init_cache_and_decode_match_jax():
    """``init_cache`` (f32, 12 positions) and 3 decode steps: logits and
    the self and cross caches after each."""
    cfg, tree, frames, tok = _setup()
    tcfg = tconfigs.get_smoke(ARCH)
    params = lm_params_from_numpy(tree)
    jenc = je.encode(cfg, tree, frames)
    jc = je.init_cache(cfg, tree, jenc, 12, dtype=jnp.float32)
    with torch.no_grad():
        tc = te.init_cache(tcfg, params, te.encode(tcfg, params, _t(frames)),
                           12, torch.float32)
    step = jax.jit(lambda p, t, c: je.decode_step(cfg, p, t, c),
                   compiler_options=FAST_COMPILE)
    for i in range(3):
        for k in ("k", "v", "xk", "xv"):
            _close(tc[k], jc[k], f"step {i} {k}")
        assert tc["pos"] == int(jc["pos"]) == i
        jlog, jc = step(tree, tok[:, i:i + 1], jc)
        with torch.no_grad():
            log, tc = te.decode_step(tcfg, params, _t(tok[:, i:i + 1]), tc)
        _close(log, jlog, f"decode {i}")


def test_serve_steps_match_jax():
    """``serve.lm``: the prefill's next token is 0 (JAX's placeholder
    readout), then greedy decoding from it against JAX's."""
    cfg, tree, frames, _ = _setup()
    tcfg = tconfigs.get_smoke(ARCH)
    params = lm.load_serving_params(lm_params_from_numpy(tree), tcfg, "cpu",
                                    serve_dtype="float32")
    nxt, cache = lm.prefill_step(tcfg, params, _t(frames), None, 12)
    assert nxt.tolist() == [0] * B
    assert cache["k"].dtype == torch.bfloat16
    jc = je.init_cache(cfg, tree, je.encode(cfg, tree, frames), 12)
    tok_t, jtok = nxt[:, None], jnp.zeros((B, 1), jnp.int32)
    for _ in range(2):
        tok_t, cache = lm.decode_step(tcfg, params, tok_t, cache, None)
        jlog, jc = je.decode_step(cfg, tree, jtok, jc)
        jtok = jnp.argmax(jlog, -1)
        assert tok_t.tolist() == np.asarray(jtok).tolist()
    with pytest.raises(NotImplementedError, match="init_cache"):
        tapi.family_fns(tcfg).init_decode_state(tcfg, B, 12)


def test_whisper_decode_matches_forward():
    """Mirror of tests/test_models_smoke.py::test_whisper_decode_matches_
    forward on the port's own seeded init."""
    cfg = tconfigs.get_smoke(ARCH)
    params = te.whisper_init(cfg, 0, device="cpu")
    rng = np.random.default_rng(4)
    frames = _t(rng.normal(0, 1, (B, SE, cfg.d_model)).astype(np.float32))
    dtok = _t(rng.integers(0, cfg.vocab_size, (B, SD)))
    with torch.no_grad():
        full = te.forward_train(cfg, params, frames, dtok)
        cache = te.init_cache(cfg, params, te.encode(cfg, params, frames),
                              SD, torch.float32)
        errs = []
        for i in range(SD):
            lg, cache = te.decode_step(cfg, params, dtok[:, i:i + 1], cache)
            errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 1e-4
