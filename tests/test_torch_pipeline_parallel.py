"""GPipe over ``torch.distributed`` (``repro_torch.distributed.pipeline``)
and the host mesh (``repro_torch.launch.mesh``) against the JAX package
on the CPU.

Four gloo ranks (spawned processes that import nothing of JAX, a
``FileStore`` rendezvous) run ``gpipe_apply`` at the sizes of
tests/test_pipeline_parallel.py: L 8 layers of ``tanh(h @ w)``, D 16,
M 6 microbatches of MB 4, S 4 stages; also M 2 (fewer microbatches than
stages) and S 1 (a (4, 1) ("data", "pipe") mesh: four one-stage lines),
and S 2 on a (2, 2) ("data", "pipe") mesh whose lines are checked by
all-reduces.  Each rank returns its outputs and its stage's gradient of
sum(out ** 2) and logs every ring hop.  JAX's ``gpipe_apply`` runs the
same inputs (numpy, seeded) in a subprocess with 4 forced host devices,
as the JAX test does.  Outputs within 1e-5 of JAX's, gradients within
1e-4 of JAX's and of the sequential layers' (torch.autograd), every rank
holding the same outputs, every rank issuing the same hops in the same
order (M + S - 1 forward, then as many backward), ``stage_fn`` run M
times a rank.  The JAX subprocess and the ranks start together, before
the first test that reads them; each has its own timeout.
"""
import os
import queue
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402

from repro_torch.distributed import pipeline as tpipe  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
L, D, MB = 8, 16, 4
TIMEOUT = 240  # seconds, for the spawn and the subprocess
CASES = {"m6_s4": (6, 4), "m2_s4": (2, 4), "m6_s1": (6, 1)}


def _inputs():
    rng = np.random.default_rng(0)
    ws = rng.normal(0, 0.3, (L, D, D)).astype(np.float32)
    x = rng.normal(0, 1, (6, MB, D)).astype(np.float32)
    return ws, x


def _layer_stack(w, h):
    for i in range(w.shape[0]):
        h = torch.tanh(h @ w[i])
    return h


# ---------------------------------------------------------------------------
# the ranks' side (spawned: torch and the port only)
# ---------------------------------------------------------------------------

def _pipe_case(mesh, ws, x, m, s, log):
    """One gpipe_apply forward + backward on this rank's line: (outputs,
    this stage's gradient, stage_fn calls)."""
    line = tpipe.pipe_line(mesh, "pipe")
    assert line.size == s
    staged = tpipe.split_stages(torch.from_numpy(ws), s)
    mine = tpipe.stage_params(staged, line.rank).clone().requires_grad_()
    calls = []

    def stage_fn(w, h):
        calls.append(1)
        return _layer_stack(w, h)

    log.append(("case", m, s))
    out = tpipe.gpipe_apply(mine, torch.from_numpy(x[:m]), stage_fn,
                            mesh=mesh, axis="pipe")
    log.append(("backward",))
    (out ** 2).sum().backward()
    return out.detach().numpy(), mine.grad.numpy(), len(calls)


def _rank_main(rank, world, store, inputs, results):
    import torch.distributed as dist

    from repro_torch.distributed.mesh import init_data_mesh
    from repro_torch.launch.mesh import HostMesh, make_host_mesh, mesh_sizes

    torch.set_num_threads(1)
    log = []
    real = tpipe.ring_shift

    def spy(line, t, shift=1):
        log.append(("hop", shift, tuple(t.shape), line.ranks))
        return real(line, t, shift)

    tpipe.ring_shift = spy
    try:
        init_data_mesh("cpu", rank=rank, world_size=world,
                       init_method=store)
        ws, x = np.load(inputs)["ws"], np.load(inputs)["x"]
        res = {}
        pipe4 = make_host_mesh((4,), ("pipe",))
        res["m6_s4"] = _pipe_case(pipe4, ws, x, 6, 4, log)
        res["m2_s4"] = _pipe_case(pipe4, ws, x, 2, 4, log)
        res["m6_s1"] = _pipe_case(make_host_mesh((4, 1), ("data", "pipe")),
                                  ws, x, 6, 1, log)
        grid = make_host_mesh((2, 2), ("data", "pipe"))
        assert isinstance(grid, HostMesh) and grid.size == 4
        sums = {}
        for axis in ("data", "pipe"):
            line = grid.line(axis)
            sums[axis] = (line.ranks, line.rank, int(line.all_reduce(
                torch.tensor([rank])).item()))
        res["grid"] = (grid.coords, sums)
        res["m6_s2"] = _pipe_case(grid, ws, x, 6, 2, log)
        world = make_host_mesh()
        res["data_mesh"] = type(world).__name__
        res["sizes"] = [mesh_sizes(m) for m in (grid, pipe4, world)]
        res["log"] = log
        results.put((rank, res))
    except BaseException as exc:
        results.put((rank, repr(exc)))
        raise
    finally:
        tpipe.ring_shift = real
        dist.destroy_process_group()


def _collect(procs, results, deadline):
    out = {}
    try:
        while len(out) < len(procs):
            try:
                rank, res = results.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                break
            out[rank] = res
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    errors = {r: v for r, v in out.items() if isinstance(v, str)}
    assert not errors and len(out) == len(procs), \
        f"ranks failed or timed out: {errors or sorted(out)}"
    return [out[r] for r in range(len(procs))]


# ---------------------------------------------------------------------------
# the JAX package's side (a subprocess with 4 forced host devices)
# ---------------------------------------------------------------------------

_JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.distributed.pipeline import gpipe_apply, split_stages

    inputs, out = sys.argv[1], sys.argv[2]
    ws = jnp.asarray(np.load(inputs)["ws"])
    x6 = jnp.asarray(np.load(inputs)["x"])

    def stage_fn(stage_ws, h):
        def body(h, w):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, h, stage_ws)
        return h

    res = {}
    for name, m, s in (("m6_s4", 6, 4), ("m2_s4", 2, 4), ("m6_s1", 6, 1)):
        mesh = jax.make_mesh((s,), ("pipe",),
                             axis_types=(jax.sharding.AxisType.Auto,),
                             devices=jax.devices()[:s])
        x = x6[:m]

        def run(staged):
            return shard_map(
                lambda p, xx: gpipe_apply(p, xx, stage_fn, axis="pipe"),
                mesh=mesh, in_specs=(P("pipe"), P()), out_specs=P(),
                check_rep=False)(staged, x)

        staged = split_stages(ws, s)
        res[name + "_out"] = np.asarray(run(staged))
        res[name + "_grad"] = np.asarray(
            jax.grad(lambda p: jnp.sum(run(p) ** 2))(staged))
    np.savez(out, **res)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess and the 4 ranks, started together."""
    tmp = tmp_path_factory.mktemp("gpipe")
    ws, x = _inputs()
    np.savez(tmp / "inputs.npz", ws=ws, x=x)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    jproc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "inputs.npz"),
         str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, 4, f"file://{tmp}/store", str(tmp / "inputs.npz"), results),
        daemon=True) for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT
    ranks = _collect(procs, results, deadline)
    try:
        _, err = jproc.communicate(
            timeout=max(deadline - time.monotonic(), 1))
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.wait()
    assert jproc.returncode == 0, err[-3000:]
    return ranks, dict(np.load(tmp / "jax.npz")), ws, x


def _sequential(ws, x):
    """Outputs and the gradient of sum(out ** 2) of the 8 layers run one
    after another (torch.autograd)."""
    w = torch.from_numpy(ws).requires_grad_()
    out = torch.stack([_layer_stack(w, torch.from_numpy(xm)) for xm in x])
    (out ** 2).sum().backward()
    return out.detach().numpy(), w.grad.numpy()


def _stage_of(rank, s, world=4):
    """The position of ``rank`` on the pipe axis of a (world / s, s)
    mesh."""
    return rank % s


@pytest.mark.parametrize("case", sorted(CASES))
def test_gpipe_matches_jax_and_sequential(runs, case):
    ranks, jax_res, ws, x = runs
    m, s = CASES[case]
    seq_out, seq_grad = _sequential(ws, x[:m])
    seq_grad = seq_grad.reshape(s, L // s, D, D)
    for rank, res in enumerate(ranks):
        out, grad, calls = res[case]
        np.testing.assert_allclose(out, jax_res[case + "_out"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(out, seq_out, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(out, ranks[0][case][0])
        stage = _stage_of(rank, s)
        np.testing.assert_allclose(grad, jax_res[case + "_grad"][stage],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(grad, seq_grad[stage], rtol=0, atol=1e-4)
        assert calls == m   # fill / drain steps run no stage


def test_gpipe_two_stages_on_a_grid(runs):
    """S 2 on each ("pipe") line of a (2, 2) ("data", "pipe") mesh."""
    ranks, _, ws, x = runs
    seq_out, seq_grad = _sequential(ws, x)
    seq_grad = seq_grad.reshape(2, L // 2, D, D)
    for rank, res in enumerate(ranks):
        out, grad, calls = res["m6_s2"]
        np.testing.assert_allclose(out, seq_out, rtol=0, atol=1e-5)
        np.testing.assert_allclose(grad, seq_grad[rank % 2], rtol=0,
                                   atol=1e-4)
        assert calls == 6


def test_host_mesh_lines(runs):
    """(2, 2) ("data", "pipe"): rank r at (r // 2, r % 2); its data line
    is {r % 2, r % 2 + 2}, its pipe line {2 (r // 2), 2 (r // 2) + 1};
    an all-reduce over each line sums its members; a default mesh is the
    DataMesh over the job; ``mesh_sizes`` reads every kind."""
    ranks, _, _, _ = runs
    for rank, res in enumerate(ranks):
        coords, sums = res["grid"]
        assert coords == (rank // 2, rank % 2)
        data = (rank % 2, rank % 2 + 2)
        pipe = (2 * (rank // 2), 2 * (rank // 2) + 1)
        assert sums["data"] == (data, rank // 2, sum(data))
        assert sums["pipe"] == (pipe, rank % 2, sum(pipe))
        assert res["data_mesh"] == "DataMesh"
        assert res["sizes"] == [{"data": 2, "pipe": 2}, {"pipe": 4},
                                {"data": 4}]


def test_every_rank_issues_the_same_hops(runs):
    """Forward and backward, every rank of a line issues its hops in the
    same order: M + S - 1 of shift +1, then M + S - 1 of shift -1."""
    ranks, _, _, _ = runs
    logs = [res["log"] for res in ranks]
    shapes = [[e[:3] for e in log] for log in logs]
    assert all(s == shapes[0] for s in shapes)
    cases = [i for i, e in enumerate(logs[0]) if e[0] == "case"]
    for start, end in zip(cases, cases[1:] + [len(logs[0])]):
        _, m, s = logs[0][start]
        block = logs[0][start + 1:end]
        back = block.index(("backward",))
        hops_f = [e for e in block[:back] if e[0] == "hop"]
        hops_b = [e for e in block[back + 1:] if e[0] == "hop"]
        assert [e[1] for e in hops_f] == [1] * (m + s - 1)
        assert [e[1] for e in hops_b] == [-1] * (m + s - 1)


def test_split_stages_matches_jax_on_llama_smoke():
    """``split_stages`` of the converted llama3-8b SMOKE layers equals
    JAX's bit for bit, leaf by leaf."""
    import jax

    from repro.distributed.pipeline import split_stages as j_split
    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import transformer as tt

    cfg = get_smoke("llama3-8b")
    tree = jax.tree.map(lambda t: t.numpy(),
                        tt.decoder_init(cfg, 0, device="cpu"))
    got = tpipe.split_stages(lm_params_from_numpy(tree)["layers"],
                             cfg.num_layers)
    want = j_split(jax.tree.map(jax.numpy.asarray, tree["layers"]),
                   cfg.num_layers)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == 9    # ln1, ln2, 4 attention, 3 MLP
    for path, w in flat_w:
        g = got
        for k in path:
            g = g[k.key]
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        tpipe.split_stages({"w": torch.zeros(3, 2)}, 2)


def test_bubble_fraction():
    assert tpipe.bubble_fraction(4, 6) == pytest.approx(3 / 9)
    assert tpipe.bubble_fraction(1, 8) == 0.0
    assert tpipe.bubble_fraction(4, 32) < tpipe.bubble_fraction(4, 8)
    assert tpipe.bubble_fraction(4, 8) == 3 / 11


def test_split_stages_shapes():
    out = tpipe.split_stages({"w": torch.zeros(8, 3, 3),
                              "b": torch.zeros(8, 3)}, 4)
    assert out["w"].shape == (4, 2, 3, 3)
    assert out["b"].shape == (4, 2, 3)
    assert tpipe.stage_params(out, 1)["w"].shape == (2, 3, 3)
