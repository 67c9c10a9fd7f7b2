"""The port's state-space layers (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the CPU at the SMOKE sizes of zamba2 (d 64, 8
heads of 16, state 16) and rwkv6 (d 64, 4 heads of 16): Mamba2's causal
conv, ``mamba_fwd`` with its final state, its gradients, and
``mamba_decode_step`` from a non-zero state; each RWKV6 function
(``_token_shift``, ``_rwkv_decay``, ``rwkv_time_mix`` with its
checkpointed time chunks and their gradients, ``rwkv_channel_mix``,
``rwkv_layer_fwd``), the init layouts and the zero states.

One layer's parameters for both packages: the port's ``Maker`` draw
with every leaf moved by N(0, 0.05) (the zero-initialised leaves take
part), as numpy arrays for JAX.  Tolerances: f32 within ``1e-5 * max(1,
max|jax|)``, except the RWKV time scan's gradients, within ``5e-5`` (f32
roundoff of the backward through 16 recurrence steps: measured gap
2.7e-5); bf16 at DESIGN.md §4's bound, 3e-2 of the largest value and a
cosine of 0.999 (XLA keeps bf16 elementwise chains in f32 between
fusions, so the two frameworks' bf16 outputs differ by more than one
bf16 rounding whatever the casts)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import ssm as js  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import ssm as ts  # noqa: E402
from repro_torch.models.layers import Maker  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402

ZAMBA, RWKV = "zamba2-1.2b", "rwkv6-3b"
B, S = 2, 16
# JAX's references compile with LLVM's expensive passes off, to cut
# compile time (as tests/test_torch_dp.py does)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jit(fn, **kw):
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


def _close(got, want, msg="", tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), (msg, err)


def _bf16(got, want, msg=""):
    got = got.detach().float().numpy().ravel()
    want = np.asarray(want, np.float32).ravel()
    err = float(np.abs(got - want).max())
    assert err <= 3e-2 * max(1.0, float(np.abs(want).max())), (msg, err)
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos >= 0.999, (msg, cos)


def _t(a, dtype=None):
    t = lm_params_from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _layer(init, arch, seed):
    """One layer's parameters (numpy, f32) from the port's ``Maker``, every
    leaf moved by N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    tree = init(Maker(seed, "cpu"), tconfigs.get_smoke(arch))
    return jax.tree.map(lambda t: (t.numpy() + 0.05 * rng.standard_normal(
        t.shape)).astype(np.float32), tree)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _mamba_state(cfg, seed):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return {"ssm": _x((B, nh, cfg.ssm_head_dim, cfg.ssm_state), seed),
            "conv": _x((B, cfg.ssm_conv - 1, d_in + 2 * cfg.ssm_state),
                       seed + 1)}


def test_init_layouts_match_jax():
    for arch, j_init, t_init in ((ZAMBA, js.mamba_init, ts.mamba_init),
                                 (RWKV, js.rwkv_layer_init,
                                  ts.rwkv_layer_init)):
        want = j_init(js.Maker(None, {}), jax_smoke(arch))  # abstract mode
        got = t_init(Maker(0, "cpu"), tconfigs.get_smoke(arch))
        assert sorted(got) == sorted(want)
        ref = jax.eval_shape(lambda a=arch, f=j_init: f(
            js.Maker(jax.random.PRNGKey(0)), jax_smoke(a)))
        for t, w in zip(leaves(got), jax.tree.leaves(ref)):
            assert tuple(t.shape) == w.shape
    cfg = tconfigs.get_smoke(ZAMBA)
    st = ts.mamba_init_state(cfg, B, torch.bfloat16, "cpu")
    jst = js.mamba_init_state(jax_smoke(ZAMBA), B, jnp.bfloat16)
    for k in ("ssm", "conv"):
        assert tuple(st[k].shape) == jst[k].shape and not st[k].any()
    assert st["ssm"].dtype == torch.float32
    assert st["conv"].dtype == torch.bfloat16
    rst = ts.rwkv_init_state(tconfigs.get_smoke(RWKV), B, device="cpu")
    jrst = js.rwkv_init_state(jax_smoke(RWKV), B)
    for k in jrst:
        assert tuple(rst[k].shape) == jrst[k].shape and not rst[k].any()


def test_causal_conv_matches_jax():
    x, w, b = _x((B, S, 24), 0), _x((4, 24), 1), _x((24,), 2)
    _close(ts._causal_conv(_t(x), _t(w), _t(b)), js._causal_conv(x, w, b))


@pytest.mark.parametrize("chunk", [4, 16])
def test_mamba_fwd_matches_jax(chunk):
    """Output and final state (``return_state``) at two SSD chunks (8 in
    the gradient and bf16 tests)."""
    p = _layer(ts.mamba_init, ZAMBA, 0)
    x = _x((B, S, 64), 3)
    want, wst = _jit(lambda pp, xx: js.mamba_fwd(
        pp, xx, jax_smoke(ZAMBA), chunk=chunk, return_state=True))(p, x)
    got, st = ts.mamba_fwd(lm_params_from_numpy(p), _t(x),
                           tconfigs.get_smoke(ZAMBA), chunk=chunk,
                           return_state=True)
    _close(got, want, "out")
    _close(st["ssm"], wst["ssm"], "ssm state")
    _close(st["conv"], wst["conv"], "conv tail")
    assert st["ssm"].dtype == torch.float32
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ts.mamba_fwd(lm_params_from_numpy(p), _t(x[:, :10]),
                     tconfigs.get_smoke(ZAMBA), chunk=chunk)


def test_mamba_fwd_grads_match_jax():
    """Gradients of a random projection of the output with respect to x
    and every parameter leaf (SSD chunk 8)."""
    p = _layer(ts.mamba_init, ZAMBA, 1)
    x, r = _x((B, S, 64), 4), _x((B, S, 64), 5)
    cfg = jax_smoke(ZAMBA)
    (jgx, jgp) = _jit(jax.grad(
        lambda xx, pp: jnp.sum(js.mamba_fwd(pp, xx, cfg, chunk=8) * r),
        argnums=(0, 1)))(x, p)
    tp = lm_params_from_numpy(p)
    tx = _t(x).requires_grad_()
    flat = [t.requires_grad_() for t in leaves(tp)]
    out = ts.mamba_fwd(tp, tx, tconfigs.get_smoke(ZAMBA), chunk=8)
    grads = torch.autograd.grad((out * _t(r)).sum(), [tx] + flat)
    _close(grads[0], jgx, "dx")
    for i, (g, w) in enumerate(zip(grads[1:], jax.tree.leaves(jgp))):
        _close(g, w, f"leaf {i}")


def test_mamba_decode_step_matches_jax():
    """Two steps from a non-zero state: output and both states."""
    p = _layer(ts.mamba_init, ZAMBA, 2)
    cfg, tcfg = jax_smoke(ZAMBA), tconfigs.get_smoke(ZAMBA)
    st = _mamba_state(cfg, 6)
    tst = {k: _t(v) for k, v in st.items()}
    tp = lm_params_from_numpy(p)
    step = _jit(lambda pp, xx, ss: js.mamba_decode_step(pp, xx, ss, cfg))
    for i in range(2):
        x = _x((B, 1, 64), 8 + i)
        y, st = step(p, x, st)
        ty, tst = ts.mamba_decode_step(tp, _t(x), tst, tcfg)
        _close(ty, y, f"step {i}")
        for k in st:
            _close(tst[k], st[k], f"step {i} {k}")


def test_mamba_bf16_matches_jax():
    """``mamba_fwd`` and ``mamba_decode_step`` on bf16 parameters and
    inputs against JAX in bf16: bf16 outputs, f32 SSM states."""
    p = _layer(ts.mamba_init, ZAMBA, 3)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    tp = {k: v.to(torch.bfloat16) for k, v in
          lm_params_from_numpy(p).items()}
    cfg = jax_smoke(ZAMBA).with_(compute_dtype="bfloat16")
    tcfg = tconfigs.get_smoke(ZAMBA).with_(compute_dtype="bfloat16")
    x = _x((B, S, 64), 10)
    want, wst = _jit(lambda pp, xx: js.mamba_fwd(
        pp, xx, cfg, chunk=8, return_state=True))(
            jp, jnp.asarray(x, jnp.bfloat16))
    got, st = ts.mamba_fwd(tp, _t(x, torch.bfloat16), tcfg, chunk=8,
                           return_state=True)
    assert got.dtype == torch.bfloat16 and st["ssm"].dtype == torch.float32
    _bf16(got, want, "out")
    _bf16(st["ssm"], wst["ssm"], "ssm state")
    x1 = _x((B, 1, 64), 11)
    y, wst = _jit(lambda pp, xx, ss: js.mamba_decode_step(pp, xx, ss, cfg))(
        jp, jnp.asarray(x1, jnp.bfloat16), wst)
    ty, st = ts.mamba_decode_step(tp, _t(x1, torch.bfloat16), st, tcfg)
    assert ty.dtype == torch.bfloat16 and st["ssm"].dtype == torch.float32
    _bf16(ty, y, "decode out")
    _bf16(st["ssm"], wst["ssm"], "decode ssm state")


def _rwkv_state(cfg, seed):
    nh = cfg.d_model // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim
    return {"wkv": _x((B, nh, hd, hd), seed),
            "tm_prev": _x((B, 1, cfg.d_model), seed + 1),
            "cm_prev": _x((B, 1, cfg.d_model), seed + 2)}


def test_rwkv_token_shift_and_decay_match_jax():
    p = _layer(ts.rwkv_layer_init, RWKV, 4)
    x, prev = _x((B, S, 64), 12), _x((B, 1, 64), 13)
    _close(ts._token_shift(_t(x), _t(prev)), js._token_shift(x, prev))
    # a wide spread of w_raw, so that both clamps bite
    xw = 20 * _x((B, S, 64), 14)
    tp = lm_params_from_numpy(p)
    got = ts._rwkv_decay(tp, _t(xw))
    assert got.dtype == torch.float32
    _close(got, js._rwkv_decay(p, xw))


@pytest.mark.parametrize("time_chunk", [4, 256])
def test_rwkv_time_mix_matches_jax(time_chunk):
    """Output, final WKV state and last token from a non-zero state, and
    the gradients with respect to x, the state and every leaf: at
    ``time_chunk`` 4 the scan runs in 4 checkpointed chunks in both
    packages, at 256 in one piece."""
    p = _layer(ts.rwkv_layer_init, RWKV, 5)
    cfg, tcfg = jax_smoke(RWKV), tconfigs.get_smoke(RWKV)
    x, r = _x((B, S, 64), 15), _x((B, S, 64), 16)
    st = _rwkv_state(cfg, 17)

    def jfn(xx, pp, wkv):
        out, new, last = js.rwkv_time_mix(pp, xx, cfg, wkv, st["tm_prev"],
                                          time_chunk=time_chunk)
        return jnp.sum(out * r) + jnp.sum(new), (out, new, last)

    (jg, (out, new, last)) = _jit(jax.grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True))(x, p, st["wkv"])
    tp = lm_params_from_numpy(p)
    tx, twkv = _t(x).requires_grad_(), _t(st["wkv"]).requires_grad_()
    flat = [t.requires_grad_() for t in leaves(tp)]
    tout, tnew, tlast = ts.rwkv_time_mix(tp, tx, tcfg, twkv,
                                         _t(st["tm_prev"]),
                                         time_chunk=time_chunk)
    _close(tout, out, "out")
    _close(tnew, new, "state")
    _close(tlast, last, "last token")
    # the time mix leaves ln1 / ln2 and the channel mix's leaves unused:
    # JAX's gradients of those are zeros
    grads = torch.autograd.grad((tout * _t(r)).sum() + tnew.sum(),
                                [tx, twkv] + flat, allow_unused=True,
                                materialize_grads=True)
    _close(grads[0], jg[0], "dx", 5e-5)
    _close(grads[1], jg[2], "dstate", 5e-5)
    for i, (g, w) in enumerate(zip(grads[2:], jax.tree.leaves(jg[1]))):
        _close(g, w, f"leaf {i}", 5e-5)


def test_rwkv_channel_mix_and_layer_match_jax():
    p = _layer(ts.rwkv_layer_init, RWKV, 6)
    cfg, tcfg = jax_smoke(RWKV), tconfigs.get_smoke(RWKV)
    tp = lm_params_from_numpy(p)
    x = _x((B, S, 64), 18)
    st = _rwkv_state(cfg, 19)
    out, last = js.rwkv_channel_mix(p, x, st["cm_prev"])
    tout, tlast = ts.rwkv_channel_mix(tp, _t(x), _t(st["cm_prev"]))
    _close(tout, out, "channel mix")
    _close(tlast, last, "channel mix last token")
    y, new = _jit(lambda pp, xx, ss: js.rwkv_layer_fwd(pp, xx, cfg, ss))(
        p, x, st)
    ty, tnew = ts.rwkv_layer_fwd(tp, _t(x), tcfg,
                                 {k: _t(v) for k, v in st.items()})
    _close(ty, y, "layer")
    for k in new:
        _close(tnew[k], new[k], f"layer state {k}")
