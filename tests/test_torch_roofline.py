"""The H100 roofline (``repro_torch.analysis.roofline``) and the dry run
(``repro_torch.launch.dryrun``) against the JAX package on the CPU.

For every ok (arch x shape) cell on both production meshes (256 / 512
chips, model_par 16, the roofline's accum steps), the port's
``_param_counts``, ``analytic_flops``, ``analytic_bytes``,
``analytic_collective_bytes`` and ``decode_state_bytes`` equal JAX's:
integers exactly, floats to rtol 1e-12 (JAX's ``_param_counts`` is
cached here, by arch, to spare its repeated ``eval_shape``).  The
constants are the H100 SXM's datasheet peaks.  The dry run's records:
every cell and the CHGNet cell, nulls where JAX reads a compiler
artifact, per-rank argument bytes equal to the sum over JAX's own
structures (``param_structs``, ``adam_init``, ``input_specs``,
``decode_state_structs``) of each leaf's bytes divided by the sizes of
the axes its ``PartitionSpec`` names; then ``build_rows`` /
``to_markdown`` / ``load_and_build`` on a records file the dry run wrote.
"""
import functools
import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.analysis import roofline as jr  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.api import family_fns as j_fns  # noqa: E402
from repro.optim.adam import adam_init as j_adam_init  # noqa: E402
from repro_torch.analysis import roofline as tr  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

MESHES = {"16x16": (False, {"data": 16, "model": 16}, 256),
          "2x16x16": (True, {"pod": 2, "data": 16, "model": 16}, 512)}
OK_CELLS = [(a, s) for a in ARCH_IDS for s in jshapes.SHAPES
            if jshapes.cell_status(j_config(a), jshapes.SHAPES[s]) == "ok"]


@pytest.fixture(scope="module", autouse=True)
def _cached_jax_counts():
    real = jr._param_counts
    cache = functools.cache(lambda name: real(j_config(name)))
    jr._param_counts = lambda cfg: cache(cfg.name)
    yield
    jr._param_counts = real


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "dryrun.json"
    assert dryrun.main(["--all", "--out", str(out)]) == 0
    with open(out) as f:
        return out, json.load(f)


def _eq(got, want, msg=""):
    if isinstance(want, int) and isinstance(got, int):
        assert got == want, msg
    else:
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0), \
            (msg, got, want)


def test_constants_are_the_h100s():
    assert tr.PEAK_FLOPS == 989e12
    assert tr.HBM_BW == 3.35e12
    assert tr.LINK_BW == 450e9


def test_param_counts_match_jax():
    for arch in ARCH_IDS:
        assert tr._param_counts(t_config(arch)) == \
            jr._param_counts(j_config(arch)), arch


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("cell", OK_CELLS, ids="-".join)
def test_analytic_models_match_jax(cell, mesh):
    arch, name = cell
    jc, tc = j_config(arch), t_config(arch)
    js, ts = jshapes.SHAPES[name], tshapes.SHAPES[name]
    _, _, chips = MESHES[mesh]
    dp_total = chips // 16
    accum = tr.roofline_accum(tc, ts, dp_total)
    if js.kind == "train":
        want = jsteps.CELL_OVERRIDES.get((arch, name), {}).get(
            "accum_steps") or jsteps.default_accum_steps(jc, js, dp_total)
        assert accum == max(1, min(want, js.batch // dp_total))
    kw = dict(chips=chips, model_par=16, dp_total=dp_total, accum=accum)
    for k, v in jr.analytic_flops(jc, js).items():
        _eq(tr.analytic_flops(tc, ts)[k], v, k)
    _eq(tr.analytic_bytes(tc, ts, **kw), jr.analytic_bytes(jc, js, **kw))
    _eq(tr.analytic_collective_bytes(tc, ts, **kw),
        jr.analytic_collective_bytes(jc, js, **kw))
    _eq(tr.decode_state_bytes(tc, js.batch, js.seq),
        jr.decode_state_bytes(jc, js.batch, js.seq))


def test_dryrun_writes_every_cell(records):
    _, recs = records
    assert len(recs) == 2 * 40 + 2
    status = [r["status"] for r in recs]
    assert sum(s == "ok" for s in status) == 2 * 32 + 2
    assert sum(s.startswith("skip") for s in status) == 2 * 8
    for r in recs:
        if r["status"] != "ok":
            continue
        assert r["cost"] == {"flops": None, "bytes_accessed": None}
        assert r["collectives"] is None
        assert r["memory"]["temp_bytes"] is None
        assert r["null_reason"] == "no compiler artifact"
        assert r["fits_80gb"] == (r["memory"]["argument_bytes"] <= 80e9)
        if r["kind"] == "train":
            assert r["grad_allreduce"]["buckets"] >= 1


@functools.cache
def _j_params(arch, dtype):
    return jsteps.param_structs(j_config(arch), dtype=dtype)


def _j_rank_bytes(tree, specs, sizes):
    """Sum over a JAX structure tree of each leaf's bytes over the sizes
    of the axes its PartitionSpec names."""
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0.0
    for leaf, spec in zip(leaves, spec_leaves):
        div = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    div *= sizes[a]
        total += math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize / div
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_rank_bytes_match_jax_structures(records, arch):
    _, recs = records
    jc = j_config(arch)
    fns = j_fns(jc)
    for r in recs:
        if r["arch"] != arch or r["status"] != "ok":
            continue
        multi, sizes, _ = MESHES[r["mesh"]]
        shape = jshapes.SHAPES[r["shape"]]
        specs = fns.specs(jc, sizes)
        io = jshapes.input_specs(jc, shape, multi_pod=multi,
                                 mesh_sizes=sizes)
        if shape.kind == "train":
            params = _j_params(arch, None)
            opt = jax.eval_shape(j_adam_init, params)
            want = _j_rank_bytes(params, specs, sizes) + _j_rank_bytes(
                opt, {"mu": specs, "nu": specs, "count": P()}, sizes)
        else:
            want = _j_rank_bytes(_j_params(arch, "bfloat16"), specs, sizes)
        want += _j_rank_bytes(io["args"], io["specs"], sizes)
        if shape.kind == "prefill":
            state, sspec = jshapes.decode_state_structs(
                jc, shape.batch, shape.seq, multi_pod=multi,
                mesh_sizes=sizes)
            want += _j_rank_bytes(state, sspec, sizes)
        assert math.isclose(r["memory"]["argument_bytes"], want,
                            rel_tol=1e-12), (r["shape"], r["mesh"])


def test_chgnet_cell(records):
    _, recs = records
    cells = [r for r in recs if r["arch"] == "chgnet-fastchgnet"]
    assert sorted(r["mesh"] for r in cells) == ["16x16", "2x16x16"]
    for r in cells:
        per_dev = 2048 // (512 if r["mesh"] == "2x16x16" else 256)
        assert r["per_device_batch"] == per_dev
        assert r["capacities"] == {"atoms": 64 * per_dev,
                                   "bonds": 1536 * per_dev,
                                   "angles": 2048 * per_dev}
        b = r["bytes"]
        assert b["opt_state"]["per_rank"] == 2 * b["params"]["per_rank"] + 4
        assert r["grad_allreduce"]["bytes"] == b["params"]["per_rank"]


def test_build_rows_and_markdown(records, tmp_path):
    path, recs = records
    subset = [r for r in recs if r["arch"] in ("llama3-8b", "rwkv6-3b")
              or r["arch"] == "chgnet-fastchgnet"
              or r["status"] != "ok"]
    sub = tmp_path / "few.json"
    sub.write_text(json.dumps(subset))
    rows, got = tr.load_and_build(str(sub))
    assert got == subset
    assert len(rows) == 2 * (3 + 4)   # llama's 3 + rwkv's 4 cells, 2 meshes
    for row in rows:
        tc, ts = t_config(row.arch), tshapes.SHAPES[row.shape]
        dp = row.chips // 16
        terms = tr.roofline_terms(tc, ts, chips=row.chips, model_par=16,
                                  dp_total=dp,
                                  accum=tr.roofline_accum(tc, ts, dp))
        assert (row.compute_s, row.memory_s, row.collective_s) == \
            (terms["compute"], terms["memory"], terms["collective"])
        assert row.dominant == terms["dominant"]
        assert row.corr == 1.0 and row.hlo_flops_per_chip is None
        assert row.bottleneck_sentence()
    md = tr.to_markdown(rows).splitlines()
    assert len(md) == 2 + len(rows)
    assert md[0].startswith("| arch | shape | mesh |")
    assert all(line.count("|") == 11 for line in md)
