"""LM training in the port against the JAX package on the CPU, at the
SMOKE sizes in f32, for every ported architecture (llama3, gemma, qwen3,
qwen1.5 with its QKV bias, phi3.5-moe, deepseek-moe): ``lm_loss`` and
every gradient leaf against ``jax.value_and_grad`` of JAX's ``lm_loss``,
three Adam steps of the JAX launcher's LM mode, ``make_lm_train_step``
with accumulation, clipping and the bf16 round trip against a JAX
reference written here from ``value_and_grad``, the microbatch sum,
``clip_by_global_norm`` and ``adam_update``, the one-step smoke of
tests/test_models_smoke.py, the launcher and the family API.

Both packages get one parameter tree (the port's seeded ``decoder_init``,
whose tree JAX's matches leaf for leaf; the port's copy through
``convert.lm_params_from_numpy``) and the same numpy tokens.  Tolerance:
``1e-5 * max(1, max|jax|)`` per leaf, for every element.  The Adam steps
are taken by the port's ``make_lm_train_step`` with JAX's gradients fed
in (``_feed_jax_grads``): at each step the port computes its own loss
and gradients, which are held to JAX's, and then steps on JAX's.  Adam
divides by the gradient's RMS plus 1e-8, which magnifies the two
frameworks' f32 roundoff up to a whole step where a gradient is near
zero; feeding the same gradients keeps that roundoff out of the
parameters, so every parameter element is held at 1e-5."""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.optim.adam import adam_init as j_adam_init  # noqa: E402
from repro.optim.adam import adam_update as j_adam_update  # noqa: E402
from repro.optim.grad import clip_by_global_norm as j_clip  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.steps import make_lm_train_step  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim.adam import adam_init  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402

PORTED = ["llama3-8b", "gemma-2b", "qwen3-8b", "qwen1.5-110b",
          "phi3.5-moe-42b-a6.6b", "deepseek-moe-16b"]
ADAM_STEPS = 3
LM_GRADS = steps.lm_grads


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, msg
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), (msg, err)


def _feed_jax_grads(monkeypatch, want, msg=""):
    """Have ``make_lm_train_step`` step on JAX's gradients: each call of
    ``launch.steps.lm_grads`` computes the port's loss and gradients,
    holds them to the next ``(loss, grads)`` of ``want``, and returns the
    port's loss with JAX's gradients."""
    want = iter(want)

    def fed(cfg, params, inputs, accum_steps=1):
        loss, grads = LM_GRADS(cfg, params, inputs, accum_steps)
        jloss, jgrads = next(want)
        _close(loss, jloss, f"{msg} loss")
        jflat = jax.tree.leaves(jgrads)
        assert len(grads) == len(jflat)
        for i, (g, w) in enumerate(zip(grads, jflat)):
            _close(g, w, f"{msg} grad leaf {i}")
        return loss, [torch.from_numpy(np.array(w)) for w in jflat]

    monkeypatch.setattr(steps, "lm_grads", fed)


def _torch(batch):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]


def _init(arch, seed):
    """One parameter tree for both packages: the port's ``decoder_init``
    of the SMOKE config as numpy arrays (JAX's own init is slow eagerly
    on the CPU, and its tree has the same leaves)."""
    tree = tt.decoder_init(tconfigs.get_smoke(arch), seed, device="cpu")
    return jax.tree.map(lambda t: t.numpy(), tree)


def _tree(params):
    """The port's copy of a JAX tree, its leaves recording gradients."""
    tree = lm_params_from_numpy(jax.tree.map(np.asarray, params))
    for t in leaves(tree):
        t.requires_grad_()
    return tree


def _batches(cfg, n, b=4, s=32):
    """The JAX launcher's LM batches: numpy default_rng(0) tokens and
    labels, positions 0..S-1."""
    rng = np.random.default_rng(0)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    return [(rng.integers(0, cfg.vocab_size, (b, s)),
             rng.integers(0, cfg.vocab_size, (b, s)), pos)
            for _ in range(n)]


@functools.cache
def _value_and_grad(arch):
    """JAX's ``lm_loss`` and its gradient, jitted once per arch (the
    fixture and the accumulation test share the compiled (4, 32) step)."""
    cfg = jax_smoke(arch)
    return jax.jit(jax.value_and_grad(
        lambda p, x, y, pos: jt.lm_loss(cfg, p, x, y, pos)))


@pytest.fixture(scope="module", params=PORTED)
def run(request):
    """JAX's side of ``train_lm``: for each of ``ADAM_STEPS`` batches the
    loss and gradients, and the parameters after that Adam step at 1e-3;
    the initial parameters and the batches."""
    arch = request.param
    cfg = jax_smoke(arch)
    params = jax.tree.map(jnp.asarray, _init(arch, 0))
    batches = _batches(cfg, ADAM_STEPS)
    vg = _value_and_grad(arch)
    adam = jax.jit(j_adam_update)
    p, opt = params, jax.jit(j_adam_init)(params)
    out = {"arch": arch, "params": params, "batches": batches, "steps": []}
    for batch in batches:
        loss, grads = vg(p, *(jnp.asarray(a) for a in batch))
        p, opt = adam(grads, opt, p, 1e-3)
        out["steps"].append((loss, grads, p))
    return out


def test_lm_loss_and_grads_match_jax(run):
    cfg = tconfigs.get_smoke(run["arch"])
    tree = _tree(run["params"])
    loss = tapi.family_fns(cfg).loss(cfg, tree, *_torch(run["batches"][0]))
    assert loss.dtype == torch.float32 and loss.shape == ()
    jloss, jgrads, _ = run["steps"][0]
    _close(loss, jloss, "loss")
    grads = torch.autograd.grad(loss, leaves(tree))
    want = jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(g, w, f"{run['arch']} leaf {i}")


def test_train_lm_adam_steps_match_jax(run, monkeypatch):
    """Three steps of the launcher's LM step (``make_lm_train_step`` at
    Adam 1e-3, unclipped): at each step the port's loss and every
    gradient leaf, then, with JAX's gradients fed in, every parameter
    element after the step."""
    cfg = tconfigs.get_smoke(run["arch"])
    tree = lm_params_from_numpy(jax.tree.map(np.asarray, run["params"]))
    opt = adam_init(tree)
    step = make_lm_train_step(cfg, lr=1e-3, grad_clip=math.inf)
    for t, (batch, (jloss, jgrads, jparams)) in enumerate(
            zip(run["batches"], run["steps"])):
        msg = f"{run['arch']} step {t}"
        _feed_jax_grads(monkeypatch, [(jloss, jgrads)], msg)
        tree, opt, loss = step(tree, opt, *_torch(batch))
        want = jax.tree.leaves(jparams)
        assert len(leaves(tree)) == len(want)
        for i, (g, w) in enumerate(zip(leaves(tree), want)):
            _close(g, w, f"{msg} parameter leaf {i}")
    assert int(opt["count"]) == ADAM_STEPS


@pytest.mark.parametrize("compress", [False, True])
def test_make_lm_train_step_matches_jax_reference(compress, monkeypatch):
    """``accum_steps=2`` with a clip that bites, two steps, against the
    train step of ``repro.launch.steps.build_cell`` written out in JAX:
    value_and_grad per microbatch (microbatch-major), the sum over K,
    divided by K, the bf16 round trip, clip_by_global_norm, adam_update.
    At each step the port's mean loss and gradients against the JAX
    reference's, then, with those gradients fed in, the clipped (and
    rounded) gradients Adam is given and every parameter element after
    the step."""
    arch = "deepseek-moe-16b" if compress else "llama3-8b"
    cfg = jax_smoke(arch)
    params = jax.tree.map(jnp.asarray, _init(arch, 1))
    batches = _batches(cfg, 2, b=8, s=32)
    k, clip, lr = 2, 0.5, 1e-3
    vg = _value_and_grad(arch)

    def j_grads(p, *inputs):
        outs = [vg(p, *(jnp.asarray(x.reshape((k, -1) + x.shape[1:])[i])
                        for x in inputs)) for i in range(k)]
        gsum = jax.tree.map(lambda *g: sum(np.asarray(x) for x in g),
                            *(g for _, g in outs))
        return (sum(float(l) for l, _ in outs) / k,
                jax.tree.map(lambda g: g / np.float32(k), gsum))

    @jax.jit
    def j_update(grads, opt, p):
        if compress:
            grads = jax.tree.map(
                lambda g: g.astype(jnp.bfloat16).astype(g.dtype), grads)
        norm = jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(grads)))
        grads = j_clip(grads, clip)
        p, opt = j_adam_update(grads, opt, p, lr)
        return p, opt, norm, grads

    step = make_lm_train_step(tconfigs.get_smoke(arch), accum_steps=k,
                              lr=lr, grad_clip=clip, compress_grads=compress)
    # Adam's update is nearly scale free, so the parameters barely see the
    # clip or the bf16 rounding: the gradients Adam is given are held too
    adam_in, real_adam = [], steps.adam_update

    def spy(grads, *args):
        adam_in.append([g.clone() for g in grads])
        return real_adam(grads, *args)

    monkeypatch.setattr(steps, "adam_update", spy)
    jp, jopt = params, jax.jit(j_adam_init)(params)
    tree = lm_params_from_numpy(jax.tree.map(np.asarray, params))
    opt = adam_init(tree)
    for t, batch in enumerate(batches):
        jloss, jgrads = j_grads(jp, *batch)
        jp, jopt, norm, jclipped = j_update(jgrads, jopt, jp)
        assert float(norm) > clip, "the clip does not bite"
        _feed_jax_grads(monkeypatch, [(jloss, jgrads)], f"{arch} step {t}")
        tree, opt, _ = step(tree, opt, *_torch(batch))
        for i, (g, w) in enumerate(zip(adam_in[-1],
                                       jax.tree.leaves(jclipped))):
            _close(g, w, f"{arch} step {t} clipped gradient leaf {i}")
        for i, (g, w) in enumerate(zip(leaves(tree), jax.tree.leaves(jp))):
            _close(g, w, f"{arch} step {t} parameter leaf {i}")
    assert len(adam_in) == 2
    assert int(opt["count"]) == 2


def _family_inputs(cfg, fns, b=2, s=16, seed=0):
    """The inputs of tests/test_models_smoke.py's ``_inputs``: tokens (or
    whisper's N(0, 1) frames), labels, and positions where the family has
    them ((B, S, 3) for M-RoPE)."""
    rng = np.random.default_rng(seed)
    if fns.token_input:
        x = rng.integers(0, cfg.vocab_size, (b, s))
    else:
        x = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    args = [x, rng.integers(0, cfg.vocab_size, (b, s))]
    if fns.has_positions:
        pos = np.broadcast_to(np.arange(s)[None], (b, s))
        if fns.positions_3d:
            pos = np.broadcast_to(pos[..., None], (b, s, 3))
        args.append(pos.astype(np.int32))
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_smoke_forward_and_train_step(arch):
    """Mirror of tests/test_models_smoke.py::
    test_smoke_forward_and_train_step for every architecture: the port's
    own seeded init, a finite loss and gradients, and one SGD step that
    lowers the loss (the hybrid at ``ssd_chunk=8``, as there)."""
    cfg = tconfigs.get_smoke(arch)
    assert cfg.family == tconfigs.get_config(arch).family
    fns = tapi.family_fns(cfg)
    params = fns.init(cfg, 0, device="cpu")
    flat = [p.requires_grad_() for p in leaves(params)]
    args = _family_inputs(cfg, fns)
    kw = dict(ssd_chunk=8) if cfg.family == "hybrid" else {}
    loss = fns.loss(cfg, params, *args, **kw)
    grads = torch.autograd.grad(loss, flat)
    assert np.isfinite(float(loss.detach()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        torch._foreach_sub_(flat, torch._foreach_mul(grads, 1e-2))
        assert float(fns.loss(cfg, params, *args, **kw)) < \
            float(loss.detach())


def test_lm_loss_casts_master_weights():
    """At a bf16 compute dtype the loss takes f32 master weights (the
    forwards refuse them), and the gradients reach the f32 leaves in
    f32, as under jax.grad of JAX's loss on f32 parameters."""
    cfg = tconfigs.get_smoke("llama3-8b").with_(compute_dtype="bfloat16")
    params = tt.decoder_init(cfg, 0, device="cpu")
    flat = [p.requires_grad_() for p in leaves(params)]
    (x, y, pos), = _batches(cfg, 1, b=2, s=8)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, y, pos)]
    with pytest.raises(TypeError, match="load_serving_params"):
        tt.forward_train(cfg, params, args[0], args[2])
    loss = tt.lm_loss(cfg, params, *args)
    assert loss.dtype == torch.float32
    grads = torch.autograd.grad(loss, flat)
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads)


def test_launcher_trains_lm(capsys):
    """``--arch <LM id>`` trains the SMOKE config (the JAX launcher's LM
    mode): deepseek-moe, whisper-medium (float frames, no positions) and
    rwkv6-3b, 2 steps each, a finite loss every step."""
    for arch in ("deepseek-moe-16b", "whisper-medium", "rwkv6-3b"):
        argv = ["--arch", arch, "--steps", "2", "--device", "cpu"]
        assert launch_train.main(argv) == 2
        out = capsys.readouterr().out
        assert f"arch={arch} (SMOKE)" in out
        losses = [float(line.split("loss")[1]) for line in out.splitlines()
                  if "step" in line and "loss" in line]
        assert len(losses) == 2 and all(np.isfinite(losses)), out
