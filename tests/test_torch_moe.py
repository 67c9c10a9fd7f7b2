"""The port's MoE family (``models.moe``, the MoE branches of
``models.transformer``) against ``repro.models`` on the CPU: the four
tests of tests/test_moe.py mirrored on the port, ``moe_apply`` against
JAX at ample and at tight capacity (the same experts, the same kept
tokens, the same output), phi3.5-moe's and deepseek-moe's SMOKE forward,
prefill and decode against JAX, the shared experts through the fused
feed-forward wrapper, the init layout, and the weight bridge.

Both packages get one parameter tree (the port's seeded init, whose
layout ``test_decoder_init_layout_matches_jax`` holds to JAX's; JAX's own
init is slow eagerly on the CPU; the port's copy through
``convert.lm_params_from_numpy``) and the same numpy inputs.  Tolerance:
f32 within ``1e-5 * max(1, max|jax|)``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.config import LMConfig as JLMConfig  # noqa: E402
from repro.models.config import MoEConfig as JMoEConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.config import LMConfig, MoEConfig  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.serve import lm  # noqa: E402

MOE = ["phi3.5-moe-42b-a6.6b", "deepseek-moe-16b"]


def _close(got, want, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), (msg, err)


def _cfgs(capacity_factor=8.0, num_shared=0):
    kw = dict(name="m", family="moe", num_layers=1, d_model=16, num_heads=2,
              num_kv_heads=2, vocab_size=32, compute_dtype="float32")
    moe = dict(num_experts=4, top_k=2, num_shared=num_shared, d_ff_expert=8,
               capacity_factor=capacity_factor)
    return (JLMConfig(**kw, moe=JMoEConfig(**moe)),
            LMConfig(**kw, moe=MoEConfig(**moe)))


def _layer(seed, capacity_factor=8.0, num_shared=0):
    """JAX's MoE layer parameters and the port's copy of them."""
    jcfg, tcfg = _cfgs(capacity_factor, num_shared)
    src = jax.tree.map(lambda t: t.numpy(), tmoe.moe_init(tl.Maker(seed),
                                                          tcfg))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, src), \
        lm_params_from_numpy(src)


def _x(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# tests/test_moe.py
# ---------------------------------------------------------------------------

def naive_moe(p, x, cfg):
    """Loop oracle, no capacity limit (exact top-k MoE), in float64."""
    b, s, d = x.shape
    m = cfg.moe
    probs = torch.softmax((x @ p["router"]).double(), -1)
    gate, idx = torch.topk(probs, m.top_k, -1)
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros((b, s, d), dtype=torch.float64)
    for bi in range(b):
        for si in range(s):
            for kk in range(m.top_k):
                e = int(idx[bi, si, kk])
                xe = x[bi, si].double()
                h = torch.nn.functional.silu(xe @ p["we_gate"][e].double()) \
                    * (xe @ p["we_up"][e].double())
                out[bi, si] += gate[bi, si, kk] * (h @ p["we_down"][e].double())
    return out


def test_moe_matches_naive_with_ample_capacity():
    _, cfg, _, p = _layer(0, 8.0)
    x = torch.from_numpy(_x(0, (2, 8, 16)))
    np.testing.assert_allclose(tmoe.moe_apply(p, x, cfg).numpy(),
                               naive_moe(p, x, cfg).numpy(), rtol=1e-3,
                               atol=1e-4)


def test_moe_capacity_drops_are_bounded():
    """Tight capacity drops tokens; the output stays finite and every
    expert keeps at most its capacity."""
    _, cfg, _, p = _layer(1, 1.0)
    x = torch.from_numpy(_x(1, (1, 32, 16)))
    out = tmoe.moe_apply(p, x, cfg)
    assert bool(torch.isfinite(out).all())
    gate, idx = tmoe.route(p, x, cfg)
    cap = tmoe.capacity(cfg, 32)
    _, slot, keep = tmoe.dispatch(x, idx, 4, cap)
    assert not bool(keep.all())
    kept = idx.reshape(1, -1)[keep]
    assert int(torch.bincount(kept, minlength=4).max()) <= cap
    assert int(keep.sum()) >= cap  # at least one expert full


def test_moe_shared_experts_add_dense_path():
    _, cfg, _, p = _layer(2, 8.0, num_shared=2)
    assert "shared" in p
    x = torch.from_numpy(_x(2, (2, 4, 16)))
    out = tmoe.moe_apply(p, x, cfg)
    shared = tl.gated_mlp_apply(p["shared"], x, "silu")
    assert not torch.allclose(out, out - shared)


def test_moe_grads_flow_through_router_and_experts():
    jcfg, cfg, jp, p = _layer(3, 4.0)
    x = _x(3, (2, 8, 16))
    flat = [t.requires_grad_() for t in leaves(p)]
    loss = (tmoe.moe_apply(p, torch.from_numpy(x), cfg) ** 2).sum()
    grads = dict(zip(sorted(p), torch.autograd.grad(loss, flat)))
    assert float(grads["router"].abs().sum()) > 0
    assert float(grads["we_gate"].abs().sum()) > 0
    want = jax.jit(jax.grad(lambda q: jnp.sum(
        jmoe.moe_apply(q, jnp.asarray(x), jcfg) ** 2)))(jp)
    for k in grads:
        _close(grads[k], want[k], k)


# ---------------------------------------------------------------------------
# routing, dispatch and output against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
def test_moe_apply_matches_jax(capacity_factor):
    """The same experts, the same kept (token, choice) pairs, the same
    slots and the same output as JAX, with every expert under capacity
    (8.0) and with tokens dropped (1.0)."""
    jcfg, cfg, jp, p = _layer(4, capacity_factor, num_shared=1)
    x = _x(4, (3, 32, 16))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    probs = jax.nn.softmax((xj @ jp["router"]).astype(jnp.float32), -1)
    jgate, jidx = jax.lax.top_k(probs, 2)
    gate, idx = tmoe.route(p, xt, cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(gate, jgate / (jgate.sum(-1, keepdims=True) + 1e-9), "gate")
    cap = tmoe.capacity(cfg, 32)
    assert cap == max(2, int(32 * 2 * capacity_factor / 4))
    expert_in, slot, keep = tmoe.dispatch(xt, idx, 4, cap)
    j_dispatch = jax.jit(lambda xx, gg, ii: jmoe._dispatch_group(
        xx, gg, ii, 4, cap))
    for bi in range(3):
        j_in, (j_slot, _, j_keep, _) = j_dispatch(xj[bi], jgate[bi], jidx[bi])
        order = np.argsort(np.asarray(jidx[bi]).reshape(-1), kind="stable")
        np.testing.assert_array_equal(keep[bi].numpy()[order],
                                      np.asarray(j_keep))
        np.testing.assert_array_equal(slot[bi].numpy()[order],
                                      np.asarray(j_slot))
        np.testing.assert_array_equal(expert_in[bi].numpy(),
                                      np.asarray(j_in))
    assert bool(keep.all()) == (capacity_factor == 8.0)
    _close(tmoe.moe_apply(p, xt, cfg),
           jax.jit(lambda q, xx: jmoe.moe_apply(q, xx, jcfg))(jp, xj), "out")


def test_moe_shared_experts_launch_the_fused_feed_forward(monkeypatch):
    """``use_pallas`` sends the shared experts (and only them) through
    ``ops.fused_swiglu``, whose plain version runs on the CPU; the
    output equals the plain path's."""
    _, cfg, _, p = _layer(5, 8.0, num_shared=2)
    x = torch.from_numpy(_x(5, (2, 6, 16)))
    calls = []
    real = ops.fused_swiglu

    def spy(xx, *w, **kw):
        calls.append((tuple(xx.shape), tuple(w[0].shape)))
        return real(xx, *w, **kw)

    monkeypatch.setattr(ops, "fused_swiglu", spy)
    got = tmoe.moe_apply(p, x, cfg, use_pallas=True)
    assert calls == [((12, 16), (16, 16))]
    _close(got, tmoe.moe_apply(p, x, cfg))


# ---------------------------------------------------------------------------
# the MoE family's forward, prefill and decode
# ---------------------------------------------------------------------------

def _init(arch, seed):
    """The port's seeded SMOKE tree of ``arch`` as numpy arrays."""
    tree = tt.decoder_init(tconfigs.get_smoke(arch), seed, device="cpu")
    return jax.tree.map(lambda t: t.numpy(), tree)


def _model(arch, seed=0):
    src = _init(arch, seed)
    return (jax_smoke(arch), tconfigs.get_smoke(arch),
            jax.tree.map(jnp.asarray, src), lm_params_from_numpy(src))


def _tokens(cfg, b, s, seed=0):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    return tok.astype(np.int32), pos.astype(np.int32)


@pytest.mark.parametrize("arch", MOE)
def test_forward_prefill_decode_match_jax(arch):
    """Logits over 12 tokens, a prefill of 8 into a 12-position f32 cache
    (chunk 4) and 4 decode steps, each against JAX's."""
    cfg, tcfg, params, tree = _model(arch)
    tok, pos = _tokens(cfg, 2, 12)
    ttok, tpos = torch.from_numpy(tok), torch.from_numpy(pos)
    j_fwd = jax.jit(lambda p, t, q: jt.forward_train(cfg, p, t, q))
    j_prefill = jax.jit(lambda p, t, q: jt.prefill(
        cfg, p, t, q, max_len=12, chunk=4, cache_dtype=jnp.float32))
    j_decode = jax.jit(lambda p, t, c, q: jt.decode_step(cfg, p, t, c, q))
    _close(tt.forward_train(tcfg, tree, ttok, tpos),
           j_fwd(params, jnp.asarray(tok), jnp.asarray(pos)), "forward")
    lg, cache = tt.prefill(tcfg, tree, ttok[:, :8], tpos[:, :8], max_len=12,
                           chunk=4, cache_dtype=torch.float32)
    jlg, jcache = j_prefill(params, jnp.asarray(tok[:, :8]),
                            jnp.asarray(pos[:, :8]))
    _close(lg, jlg, "prefill")
    _close(cache["k"], jcache["k"], "k")
    _close(cache["v"], jcache["v"], "v")
    for i in range(8, 12):
        lg, cache = tt.decode_step(tcfg, tree, ttok[:, i:i + 1], cache,
                                   tpos[:, i:i + 1])
        jlg, jcache = j_decode(params, jnp.asarray(tok[:, i:i + 1]), jcache,
                               jnp.asarray(pos[:, i:i + 1]))
        _close(lg, jlg, f"decode {i}")
    _close(cache["k"], jcache["k"], "k after decode")
    assert cache["pos"] == 12


def test_serve_steps_run_the_moe_family():
    """``serve.lm``'s steps on deepseek-moe: greedy tokens equal the argmax
    of the model's logits; the weights cast once."""
    cfg, tcfg, params, tree = _model("deepseek-moe-16b", seed=1)
    tparams = lm.load_serving_params(tree, tcfg, "cpu", serve_dtype="float32")
    tok, pos = _tokens(cfg, 2, 6, seed=2)
    ttok, tpos = torch.from_numpy(tok), torch.from_numpy(pos)
    nxt, cache = lm.prefill_step(tcfg, tparams, ttok, tpos, 8)
    with torch.inference_mode():
        lg, _ = tt.prefill(tcfg, tparams, ttok, tpos, 8)
    assert torch.equal(nxt, lg[:, -1].argmax(-1))
    nxt2, cache = lm.decode_step(tcfg, tparams, nxt[:, None], cache,
                                 torch.full((2, 1), 6))
    assert nxt2.shape == (2, 1) and cache["pos"] == 7


def test_decoder_init_layout_matches_jax():
    """The port's seeded MoE init has the JAX tree's structure, shapes and
    dtypes, the layer leaves stacked on the layer axis."""
    for arch in MOE:
        cfg, tcfg = jax_smoke(arch), tconfigs.get_smoke(arch)
        want = jax.eval_shape(lambda k: jt.decoder_init(cfg, k),
                              jax.random.PRNGKey(0))
        got = tt.decoder_init(tcfg, 7, device="cpu")

        def flat(t, pre=""):
            for k, v in t.items():
                if isinstance(v, dict):
                    yield from flat(v, pre + k + "/")
                else:
                    yield pre + k, v
        gw, ww = dict(flat(got)), dict(flat(want))
        assert gw.keys() == ww.keys(), arch
        assert "layers/moe/router" in gw and "layers/mlp/wg" not in gw
        assert ("layers/moe/shared/wg" in gw) == (cfg.moe.num_shared > 0)
        for k in gw:
            assert tuple(gw[k].shape) == ww[k].shape, (arch, k)
            assert str(gw[k].dtype) == f"torch.{ww[k].dtype}", (arch, k)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_lm_params_from_numpy_round_trips_moe(dtype):
    src = jax.tree.map(lambda a: a.astype(dtype),
                       _init("deepseek-moe-16b", 2))
    tree = lm_params_from_numpy(src)
    assert tree["layers"]["moe"].keys() == src["layers"]["moe"].keys()
    for s, t in zip(jax.tree.leaves(src["layers"]["moe"]),
                    leaves(tree["layers"]["moe"])):
        assert tuple(t.shape) == s.shape
        if dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  s.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), s)
