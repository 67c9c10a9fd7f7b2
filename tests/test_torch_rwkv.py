"""The port's rwkv6 (``repro_torch.models.rwkv``) against
``repro.models.rwkv`` on the CPU at the SMOKE size (2 layers, d 64, 4
heads of 16): ``forward_train``, ``lm_loss`` and every gradient leaf,
prefill and decode with their stacked states, the ``serve.lm`` steps,
the init layout, and tests/test_models_smoke.py::test_rwkv_decode_
matches_forward mirrored.

Both packages get one parameter tree (the port's seeded ``rwkv_init``
with every leaf moved by N(0, 0.05), so that the zero-initialised ``w0``
takes part; as numpy arrays for JAX, the port's copy through
``convert.lm_params_from_numpy``) and the same numpy tokens.  Tolerance:
f32 within ``1e-5 * max(1, max|jax|)``; the gradients within ``5e-5``
(f32 roundoff of the backward through the time scan, as in
tests/test_torch_ssm.py: measured gap 2.7e-5, the embedding's 1.7e-5)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import rwkv as jr  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import rwkv as tr  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.serve import lm  # noqa: E402

ARCH = "rwkv6-3b"
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


@functools.cache
def _setup(seed=0):
    cfg = jax_smoke(ARCH)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda t: (t.numpy() + 0.05 * rng.standard_normal(t.shape))
        .astype(np.float32),
        tr.rwkv_init(tconfigs.get_smoke(ARCH), seed, device="cpu"))
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, tree, tok, lab


def test_init_layout_matches_jax():
    cfg = jax_smoke(ARCH)
    want = jax.eval_shape(lambda: jr.rwkv_init(cfg, jax.random.PRNGKey(0)))
    mine = tr.rwkv_init(tconfigs.get_smoke(ARCH), 0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda w: 0, want))
    for t, w in zip(leaves(mine), jax.tree.leaves(want)):
        assert tuple(t.shape) == w.shape and t.dtype == torch.float32
    st = tr.rwkv_init_states(tconfigs.get_smoke(ARCH), B, device="cpu")
    jst = jr.rwkv_init_states(cfg, B)
    for k in jst:
        assert tuple(st[k].shape) == jst[k].shape and not st[k].any()


def test_forward_matches_jax():
    cfg, tree, tok, _ = _setup()
    want = jr.forward_train(cfg, tree, tok)
    got = tr.forward_train(tconfigs.get_smoke(ARCH),
                           lm_params_from_numpy(tree), _t(tok))
    _close(got, want, "logits")


def test_lm_loss_and_grads_match_jax():
    cfg, tree, tok, lab = _setup()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jr.lm_loss(cfg, p, tok, lab)),
        compiler_options=FAST_COMPILE)(tree)
    params = lm_params_from_numpy(tree)
    flat = [p.requires_grad_() for p in leaves(params)]
    tcfg = tconfigs.get_smoke(ARCH)
    loss = tapi.family_fns(tcfg).loss(tcfg, params, _t(tok), _t(lab))
    _close(loss, jloss, "loss")
    grads = torch.autograd.grad(loss, flat)
    want = jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(g, w, f"grad leaf {i}", 5e-5)


def test_prefill_and_decode_match_jax():
    """Prefill of 8 tokens, then 2 decode steps: logits and every layer's
    stacked state after each."""
    cfg, tree, tok, _ = _setup()
    tcfg = tconfigs.get_smoke(ARCH)
    params = lm_params_from_numpy(tree)
    jlog, jst = jr.prefill(cfg, tree, tok[:, :8])
    with torch.no_grad():
        log, st = tr.prefill(tcfg, params, _t(tok[:, :8]))
    _close(log, jlog, "prefill logits")
    for k in jst:
        _close(st[k], jst[k], f"prefill {k}")
    step = jax.jit(lambda p, t, s_: jr.decode_step(cfg, p, t, s_),
                   compiler_options=FAST_COMPILE)
    for i in range(8, 10):
        jlog, jst = step(tree, tok[:, i:i + 1], jst)
        with torch.no_grad():
            log, st = tr.decode_step(tcfg, params, _t(tok[:, i:i + 1]), st)
        _close(log, jlog, f"decode {i}")
        for k in jst:
            _close(st[k], jst[k], f"decode {i} {k}")


def test_serve_steps_match_jax():
    """``serve.lm``'s greedy steps (no positions, no kernel: the family
    has no gated MLP) against the argmax of JAX's prefill and decode."""
    cfg, tree, tok, _ = _setup()
    tcfg = tconfigs.get_smoke(ARCH)
    params = lm.load_serving_params(lm_params_from_numpy(tree), tcfg, "cpu",
                                    serve_dtype="float32")
    nxt, st = lm.prefill_step(tcfg, params, _t(tok), None, S + 2)
    jlog, jst = jr.prefill(cfg, tree, tok)
    assert nxt.tolist() == np.asarray(jnp.argmax(jlog[:, -1], -1)).tolist()
    tok_t, jtok = nxt[:, None], jnp.asarray(np.asarray(nxt))[:, None]
    for _ in range(2):
        tok_t, st = lm.decode_step(tcfg, params, tok_t, st, None)
        jlog, jst = jr.decode_step(cfg, tree, jtok, jst)
        jtok = jnp.argmax(jlog, -1)
        assert tok_t.tolist() == np.asarray(jtok).tolist()


def test_rwkv_decode_matches_forward():
    """Mirror of tests/test_models_smoke.py::test_rwkv_decode_matches_
    forward on the port's own seeded init."""
    cfg = tconfigs.get_smoke(ARCH)
    params = tr.rwkv_init(cfg, 0, device="cpu")
    s = 10
    tok = _t(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, s)))
    with torch.no_grad():
        full = tr.forward_train(cfg, params, tok)
        st = tr.rwkv_init_states(cfg, B, device="cpu")
        errs = []
        for i in range(s):
            lg, st = tr.decode_step(cfg, params, tok[:, i:i + 1], st)
            errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 1e-4
