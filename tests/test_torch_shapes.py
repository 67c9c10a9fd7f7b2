"""The dry run's shapes, spec trees and cell builder
(``repro_torch.configs.shapes``, the ``*_specs`` functions,
``repro_torch.launch.steps``) against the JAX package on the CPU.

For the 10 LM archs x 4 shapes: ``cell_status`` as JAX's (32 ok, 8
skip); ``input_specs`` and ``decode_state_structs`` with JAX's shapes,
dtypes, spec tuples (``tuple(PartitionSpec)``) and donate indices, leaf
by leaf, at ``{"data": 16, "model": 16}`` and ``{"pod": 2, "data": 16,
"model": 16}``, every tensor on ``meta``; ``param_structs`` as JAX's in
shapes and dtypes (f32 and bf16), ``FamilyFns.specs`` as JAX's spec
trees; ``default_accum_steps`` under the property of
tests/test_collectives_specs.py; ``batch_input_specs`` as JAX's.  Then
``build_cell``'s train (accum 2, Adam, clip), prefill and decode steps at
llama3-8b SMOKE, and rwkv6 SMOKE's decode, held to JAX's ``build_cell``
steps jitted on a (1, 1) ("data", "model") CPU mesh with the same
converted weights and numpy inputs: the loss and every updated
parameter within 1e-5 * max(1, max|jax|), greedy tokens equal, caches
and states within 1e-5.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke as j_smoke  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.api import family_fns as j_fns  # noqa: E402
from repro.optim.adam import adam_init as j_adam_init  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke as t_smoke  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    LogicalMesh,
    make_production_mesh,
    mesh_sizes,
)
from repro_torch.models.api import family_fns as t_fns  # noqa: E402
from repro_torch.optim.adam import adam_init  # noqa: E402

MESHES = {"single": (False, {"data": 16, "model": 16}),
          "multi": (True, {"pod": 2, "data": 16, "model": 16})}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _is_spec(x):
    return isinstance(x, P)


def _walk(jtree, ttree, path=()):
    """(path, jax leaf, port leaf) triples of a JAX tree (dicts and
    tuples, ``PartitionSpec`` leaves) and the port's counterpart."""
    if isinstance(jtree, dict):
        assert sorted(jtree) == sorted(ttree), path
        for k in sorted(jtree):
            yield from _walk(jtree[k], ttree[k], path + (k,))
    elif isinstance(jtree, (tuple, list)) and not _is_spec(jtree):
        assert len(jtree) == len(ttree), path
        for i, (j, t) in enumerate(zip(jtree, ttree)):
            yield from _walk(j, t, path + (i,))
    else:
        yield path, jtree, ttree


def _same_struct(jtree, ttree, msg=""):
    n = 0
    for path, j, t in _walk(jtree, ttree):
        assert isinstance(t, torch.Tensor) and t.is_meta, (msg, path)
        assert tuple(t.shape) == tuple(j.shape), (msg, path)
        assert str(t.dtype) == f"torch.{jnp.dtype(j.dtype).name}", \
            (msg, path, t.dtype, j.dtype)
        n += 1
    return n


def _same_specs(jtree, ttree, msg=""):
    for path, j, t in _walk(jtree, ttree):
        assert _is_spec(j) and isinstance(t, tuple), (msg, path)
        assert t == tuple(j), (msg, path, t, j)


def test_cell_status_matches_jax():
    status = {}
    for arch in ARCH_IDS:
        for name in jshapes.SHAPES:
            want = jshapes.cell_status(j_config(arch), jshapes.SHAPES[name])
            got = tshapes.cell_status(t_config(arch), tshapes.SHAPES[name])
            assert got == want, (arch, name)
            status[arch, name] = got
    assert len(status) == 40
    assert sum(s == "ok" for s in status.values()) == 32
    assert tshapes.SHAPES == {k: tshapes.Shape(*dataclasses.astuple(v))
                              for k, v in jshapes.SHAPES.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_state_structs_match_jax(arch, mesh):
    multi, sizes = MESHES[mesh]
    jc, tc = j_config(arch), t_config(arch)
    for name, shape in jshapes.SHAPES.items():
        if jshapes.cell_status(jc, shape) != "ok":
            continue
        want = jshapes.input_specs(jc, shape, multi_pod=multi,
                                   mesh_sizes=sizes)
        got = tshapes.input_specs(tc, tshapes.SHAPES[name], multi_pod=multi,
                                  mesh_sizes=sizes)
        assert got["kind"] == want["kind"] and got["donate"] == want["donate"]
        assert _same_struct(want["args"], got["args"], name) >= 1
        _same_specs(want["specs"], got["specs"], name)
        if shape.kind == "decode":
            js, jsp = jshapes.decode_state_structs(
                jc, shape.batch, shape.seq, multi_pod=multi,
                mesh_sizes=sizes)
            ts, tsp = tshapes.decode_state_structs(
                tc, shape.batch, shape.seq, multi_pod=multi,
                mesh_sizes=sizes)
            _same_struct(js, ts, name)
            _same_specs(jsp, tsp, name)


@functools.cache
def _j_param_structs(arch, dtype):
    return jsteps.param_structs(j_config(arch), dtype=dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_structs_and_specs_match_jax(arch):
    jc, tc = j_config(arch), t_config(arch)
    for dtype in (None, "bfloat16"):
        _same_struct(_j_param_structs(arch, dtype),
                     tsteps.param_structs(tc, dtype=dtype), dtype)
    for multi, sizes in MESHES.values():
        _same_specs(j_fns(jc).specs(jc, sizes), t_fns(tc).specs(tc, sizes))
        for bax in (None, ("data",), ("pod", "data")):
            _same_specs(j_fns(jc).decode_state_specs(jc, sizes, bax, "model"),
                        t_fns(tc).decode_state_specs(tc, sizes, bax, "model"))


def test_meshes():
    for multi, (shape, axes) in ((False, ((16, 16), ("data", "model"))),
                                 (True, ((2, 16, 16),
                                         ("pod", "data", "model")))):
        mesh = make_production_mesh(multi_pod=multi)
        assert isinstance(mesh, LogicalMesh)
        assert (mesh.shape, mesh.axis_names) == (shape, axes)
        assert mesh.size == (512 if multi else 256)
        assert mesh_sizes(mesh) == dict(zip(axes, shape))


def test_default_accum_divides_batch():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.given(st.integers(1, 4096), st.integers(1, 64))
    @hypothesis.settings(max_examples=50, deadline=None)
    def prop(batch, dp):
        cfg = t_config("llama3-8b")
        shape = tshapes.Shape("t", "train", 4096, batch)
        a = tsteps.default_accum_steps(cfg, shape, dp)
        per_dev = max(1, batch // dp)
        assert 1 <= a <= per_dev
        assert per_dev % a == 0
        assert a == jsteps.default_accum_steps(
            j_config("llama3-8b"), jshapes.Shape("t", "train", 4096, batch),
            dp)

    prop()
    assert tsteps.CELL_OVERRIDES == jsteps.CELL_OVERRIDES


def test_batch_input_specs_match_jax():
    from repro.batching import BatchCapacities as JCaps
    from repro.core.graph import batch_input_specs as j_specs
    from repro_torch.batching import BatchCapacities
    from repro_torch.core.graph import FIELDS, batch_input_specs

    for per_dev in (4, 8):
        kw = dict(atoms=64 * per_dev, bonds=1536 * per_dev,
                  angles=2048 * per_dev)
        want = j_specs(per_dev, JCaps(**kw))
        got = batch_input_specs(per_dev, BatchCapacities(**kw))
        for k in FIELDS:
            _same_struct(getattr(want, k), getattr(got, k), k)


# ---------------------------------------------------------------------------
# build_cell's steps against JAX's, on a (1, 1) CPU mesh
# ---------------------------------------------------------------------------

def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _close(got, want, msg=""):
    """Within 1e-5 * max(1, max|want|) element by element.  A bf16 leaf
    (the caches and states) is the one rounding of f32 values that the
    two frameworks compute within that bound, so an element whose value
    lies at a rounding boundary may round the other way: such elements
    must differ by exactly one bf16 ulp, and be at most 1 in 1000."""
    bf16 = isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    got = got.detach().float().cpu().numpy() \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    if not want.size:
        return
    diff = np.abs(got - want)
    bad = diff > 1e-5 * max(1.0, float(np.abs(want).max()))
    if bf16 and bad.any():
        flips = diff[bad] == _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))[bad]
        assert flips.all() and bad.sum() <= max(1, want.size // 1000), \
            (msg, int(bad.sum()), want.size, float(diff.max()))
        return
    assert not bad.any(), (msg, float(diff.max()))


def _close_tree(got, want, msg=""):
    for path, j, t in _walk(want, got):
        if isinstance(t, int):
            assert t == int(j), (msg, path)
        else:
            _close(t, j, (msg, path))


def _jax_cell(arch, shape, **kw):
    """JAX's ``build_cell`` step jitted on a (1, 1) ("data", "model")
    mesh: a callable on concrete arrays."""
    cfg = j_smoke(arch)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    step, _, shardings, donate, outs = jsteps.build_cell(
        cfg, shape, mesh, multi_pod=False, attn_chunk=16, **kw)
    jitted = jax.jit(step, in_shardings=shardings, out_shardings=outs,
                     compiler_options=FAST_COMPILE)

    def run(*args):
        with mesh:
            return jitted(*args)

    return run


def _port_cell(arch, shape, **kw):
    step, args, specs, donate, out_specs = tsteps.build_cell(
        t_smoke(arch), shape, LogicalMesh((1, 1), ("data", "model")),
        multi_pod=False, attn_chunk=16, **kw)
    return step, args, donate


def _trees(arch, dtype=None):
    """One seeded tree for both packages: numpy leaves (cast to ``dtype``
    through JAX, so both get the same bits) and the port's copy."""
    tree = jax.tree.map(lambda t: np.asarray(t),
                        t_fns(t_smoke(arch)).init(t_smoke(arch), 0,
                                                  device="cpu"))
    if dtype is not None:
        tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)),
                            tree)
    return tree, lm_params_from_numpy(tree)


def _tokens(b, s, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


def test_build_cell_train_step_matches_jax():
    arch = "llama3-8b"
    shape = jshapes.Shape("t", "train", 32, 4)
    jtree, ttree = _trees(arch)
    cfg = t_smoke(arch)
    x, y = _tokens(4, 32, cfg.vocab_size), _tokens(4, 32, cfg.vocab_size, 1)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (4, 32)).copy()
    jp, jopt, jloss = _jax_cell(arch, shape, accum_steps=2)(
        jax.tree.map(jnp.asarray, jtree),
        j_adam_init(jax.tree.map(jnp.asarray, jtree)), x, y, pos)
    step, args, donate = _port_cell(arch, tshapes.Shape("t", "train", 32, 4),
                                    accum_steps=2)
    assert step.accum_steps == 2 and donate == (0, 1)
    assert all(a.is_meta for a in jax.tree.leaves(
        args[0], is_leaf=lambda t: isinstance(t, torch.Tensor)))
    opt = adam_init(ttree)
    tp, topt, tloss = step(ttree, opt, *(torch.from_numpy(a)
                                         for a in (x, y, pos)))
    _close(tloss, jloss, "loss")
    _close_tree(tp, jax.tree.map(np.asarray, jp), "params")
    _close_tree({"mu": topt["mu"], "nu": topt["nu"]},
                {"mu": jax.tree.map(np.asarray, jopt["mu"]),
                 "nu": jax.tree.map(np.asarray, jopt["nu"])}, "moments")


def test_build_cell_prefill_and_decode_match_jax():
    arch = "llama3-8b"
    cfg = t_smoke(arch)
    jtree, ttree = _trees(arch, jnp.bfloat16)
    jparams = jax.tree.map(jnp.asarray, jtree)
    prompt = _tokens(2, 24, cfg.vocab_size)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    pshape = jshapes.Shape("p", "prefill", 32, 2)
    jtok, jcache = _jax_cell(arch, pshape)(jparams, prompt, pos)
    step, args, donate = _port_cell(arch, tshapes.Shape("p", "prefill",
                                                        32, 2))
    assert donate == () and args[1].is_meta
    ttok, tcache = step(ttree, torch.from_numpy(prompt),
                        torch.from_numpy(pos))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _close_tree(tcache, jax.tree.map(np.asarray, jcache), "cache")
    assert tcache["k"].shape[2] == 32 and tcache["pos"] == 24

    # decode from JAX's cache, fed to both
    dshape = jshapes.Shape("d", "decode", 32, 2)
    tok = _tokens(2, 1, cfg.vocab_size, 2)
    dpos = np.full((2, 1), 24, np.int32)
    jtok, jstate = _jax_cell(arch, dshape)(jparams, tok, jcache, dpos)
    step, args, donate = _port_cell(arch, tshapes.Shape("d", "decode",
                                                        32, 2))
    assert donate == (2,) and args[2]["pos"].is_meta
    state = lm_params_from_numpy(jax.tree.map(np.asarray, jcache))
    ttok, tstate = step(ttree, torch.from_numpy(tok), state,
                        torch.from_numpy(dpos))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _close_tree(tstate, jax.tree.map(np.asarray, jstate), "state")


def test_build_cell_rwkv_decode_matches_jax():
    arch = "rwkv6-3b"
    cfg = t_smoke(arch)
    jtree, ttree = _trees(arch, jnp.bfloat16)
    rng = np.random.default_rng(3)
    nh, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    state = {
        "wkv": rng.normal(0, 0.5, (cfg.num_layers, 2, nh, hd, hd))
        .astype(np.float32),
        "tm_prev": np.asarray(jnp.asarray(rng.normal(
            0, 1, (cfg.num_layers, 2, 1, cfg.d_model)), jnp.bfloat16)),
        "cm_prev": np.asarray(jnp.asarray(rng.normal(
            0, 1, (cfg.num_layers, 2, 1, cfg.d_model)), jnp.bfloat16)),
    }
    tok = _tokens(2, 1, cfg.vocab_size)
    dshape = jshapes.Shape("d", "decode", 32, 2)
    jtok, jstate = _jax_cell(arch, dshape)(
        jax.tree.map(jnp.asarray, jtree), tok,
        jax.tree.map(jnp.asarray, state))
    step, args, donate = _port_cell(arch, tshapes.Shape("d", "decode",
                                                        32, 2))
    assert donate == (2,) and len(args) == 3
    ttok, tstate = step(ttree, torch.from_numpy(tok),
                        lm_params_from_numpy(state))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _close_tree(tstate, jax.tree.map(np.asarray, jstate), "state")
