"""One run of one benchmark cell: FastCHGNet training on one card.

The entry the window drives is ``repro_torch.train.Trainer.train`` fed by
``Prefetcher(BatchIterator(ds, batch, 1, ladder_for(ds, batch,
num_buckets=...), load_balance=True), device="cuda")``, the one-device
wiring of ``launch/train.train_chgnet``.  ``Feed`` wraps the stream the
Trainer draws from: for each batch it records the time of the draw and
the batch's real rows and passes the batch on unchanged.  The Trainer
reads each step's loss back to the host, so the time between two draws
is a step's wall time.

Set-up: crystals and labels from the seed (``datagen``), the graphs from
the port's ``build_graph``, the parameters from the seed
(``reference.chgnet.init_params``) handed to one Trainer, which trains its
first three steps through the window's own feed (the steps the reference
follows), then one step on each ladder bucket that the window will reach
and has not yet run; then the measured window.  After it, with the
program's state freed, the reference follows the first three steps and
the comparison decides ``correct``.
"""
from __future__ import annotations

import collections
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import datagen, devtrace
from perfbench.reference import chgnet as ref_model
from perfbench.reference import graph as ref_graph
from perfbench.reference import train as ref_train

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# steps the reference follows
CHECKED_STEPS = 3
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_spec(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, mix,
    limits and the metrics it reports."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(metric):
        return name in metric.get("workloads", [name])

    return {
        "cell": cell,
        "config": _json(root / config["file"]),
        "mix": _json(BENCH / "mixes" / f"{cell['traffic']}.json"),
        "limits": _json(BENCH / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def load_file(path: Path):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeds(seed: int) -> dict:
    """Independent streams for the data, the parameters and the sampler."""
    data, params, sampler = np.random.SeedSequence(seed).generate_state(3)
    return {"data": int(data), "params": int(params),
            "sampler": int(sampler)}


def train_recipe(config: dict, mix: dict) -> dict:
    total = config["train"]["epochs"] * (mix["pool"] // mix["batch"])
    return dict(config["train"], batch=mix["batch"], total_steps=total)


def _rows(batch) -> dict:
    """Real and capacity rows of a packed CPU batch."""
    return {"crystals": int(batch.crystal_mask.sum()),
            "atoms": int(batch.atom_mask.sum()),
            "bonds": int(batch.bond_offsets[-1]),
            "angles": int(batch.angle_offsets[-1]),
            "atom_cap": batch.atom_mask.shape[0],
            "bond_cap": batch.bond_mask.shape[0],
            "angle_cap": batch.angle_mask.shape[0]}


class Feed:
    """The stream ``Trainer.train`` draws from.  ``take(n)``,
    ``window(seconds)`` and ``traced(seconds)`` each hand out the next
    prefetched batches unchanged, and record for each the time of its
    draw and its real rows (in the order the prefetcher keeps)."""

    def __init__(self, prefetcher, rows: collections.deque):
        self._it = iter(prefetcher)
        self._rows = rows
        self.prefetcher = prefetcher

    def _next(self):
        item = next(self._it)
        return item, self._rows.popleft()

    def take(self, n: int, log: list):
        for _ in range(n):
            item, rows = self._next()
            log.append(rows)
            yield item

    def window(self, seconds: float, log: list, draws: list):
        clock = time.perf_counter
        draws.append(clock())
        while True:
            item, rows = self._next()
            log.append(rows)
            yield item
            draws.append(clock())
            if draws[-1] - draws[0] >= seconds:
                return

    def traced(self, seconds: float, log: list, min_steps: int = 3):
        """As ``window``, each wait and step in a profiler span."""
        rf = torch.profiler.record_function
        t0 = time.perf_counter()
        while True:
            with rf("perfbench.wait"):
                item, rows = self._next()
            log.append(rows)
            span = rf("perfbench.step")
            span.__enter__()
            try:
                yield item
            finally:
                span.__exit__(None, None, None)
            if (len(log) >= min_steps
                    and time.perf_counter() - t0 >= seconds):
                return

    def close(self):
        self._it.close()


def _leaves_copy(tree) -> list:
    return [x.detach().clone() for x in ref_model.leaves(tree)]


def _check_tree(got, want, path="params"):
    """The program's parameter tree has the reference's structure."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            raise ValueError(f"{path}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            _check_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise ValueError(f"{path}: list of another length")
        for i, (g, w) in enumerate(zip(got, want)):
            _check_tree(g, w, f"{path}[{i}]")
    elif tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"{path}: shape {tuple(got.shape)} != "
                         f"{tuple(want.shape)}")


class Program:
    """The system under test, set up for one cell and seed: the dataset,
    the prefetched feed and one Trainer whose parameters come from the
    seed.  ``fault`` plants a fault in the timed path (the checks' tests):
    ``"half_batch"`` packs each batch from the first half of its crystals.
    ``data`` reuses the crystals and dataset of an earlier ``Program`` of
    the same cell and seed."""

    def __init__(self, spec: dict, seed: int, device: str,
                 fault: str | None = None, data: tuple | None = None):
        from repro_torch.core.chgnet import CHGNetConfig
        from repro_torch.core.losses import LossWeights
        from repro_torch.core.neighbors import Crystal, build_graph
        from repro_torch.data import (BatchIterator, Prefetcher,
                                      SyntheticConfig, SyntheticDataset,
                                      build_device_batch, ladder_for)
        from repro_torch.optim.adam import AdamConfig, adam_init
        from repro_torch.train.trainer import (TrainConfig, Trainer,
                                               params_on)

        self.spec, self.device = spec, device
        config, mix = spec["config"], spec["mix"]
        self.model = config["model"]
        self.recipe = train_recipe(config, mix)
        self.seeds = seeds(seed)
        clock = time.perf_counter
        self.times = {"start": clock()}
        if data is None:
            self.crystals = datagen.make_crystals(
                mix, self.seeds["data"], self.model["r_cut_atom"])
            self.times["data"] = clock()
            prog = [Crystal(lattice=c["lattice"], frac_coords=c["frac"],
                            atomic_numbers=c["z"], energy=c["energy"],
                            forces=c["forces"], stress=c["stress"],
                            magmoms=c["magmoms"]) for c in self.crystals]
            graphs = [build_graph(c, self.model["r_cut_atom"],
                                  self.model["r_cut_bond"]) for c in prog]
            self.times["graphs"] = clock()
            self.ds = SyntheticDataset(prog, graphs, SyntheticConfig(
                num_crystals=mix["pool"],
                r_cut_atom=self.model["r_cut_atom"],
                r_cut_bond=self.model["r_cut_bond"]))
        else:
            self.crystals, self.ds = data
        batch = mix["batch"]
        self.ladder = ladder_for(self.ds, batch,
                                 num_buckets=mix["ladder_buckets"])
        iterator = BatchIterator(self.ds, batch, 1, self.ladder,
                                 load_balance=True,
                                 seed=self.seeds["sampler"],
                                 tag_indices=True)
        self.first_batches: list[dict] = []
        self.first_indices: list[np.ndarray] = []
        rows: collections.deque = collections.deque()

        def source():
            while True:
                for tagged in iterator:
                    b = tagged.batch
                    if fault == "half_batch":
                        idx = tagged.indices[:len(tagged.indices) // 2]
                        b = build_device_batch(
                            self.ds, idx, self.ladder.bucket_for(
                                *self._real(idx)), num_crystal_slots=batch)
                    if len(self.first_batches) < CHECKED_STEPS:
                        self.first_batches.append(b.numpy())
                        self.first_indices.append(np.asarray(tagged.indices))
                    rows.append(_rows(b))
                    yield b

        self.feed = Feed(Prefetcher(
            source(), device=device if device == "cuda" else None), rows)
        r = self.recipe
        self.trainer = Trainer(
            CHGNetConfig(**self.model),
            TrainConfig(global_batch=batch, total_steps=r["total_steps"],
                        base_lr=r["base_lr"], lr_k=r["lr_k"],
                        grad_clip=r["grad_clip"],
                        adam=AdamConfig(**r["adam"]),
                        loss=LossWeights(**r["loss"])),
            device=device)
        self.init = ref_model.init_params(self.model, self.seeds["params"],
                                          device)
        _check_tree(self.trainer.params, self.init)
        count = sum(x.numel() for x in ref_model.leaves(self.init))
        if count != config["param_count"]:
            raise ValueError(f"{count} parameters, the configuration "
                             f"states {config['param_count']}")
        self.trainer.params = params_on(self.init, device)
        self.trainer.opt_state = adam_init(self.trainer.params)
        self.times["trainer"] = clock()

    def _real(self, idx) -> tuple[int, int, int]:
        return (sum(self.ds.crystals[i].num_atoms for i in idx),
                sum(self.ds.graphs[i].num_bonds for i in idx),
                sum(self.ds.graphs[i].num_angles for i in idx))

    def first_steps(self) -> dict:
        """The first steps through the feed, read as ``ref_train.replay``
        returns them: each step's metrics, the first step's outputs at its
        real rows (as the step's ``chgnet_apply`` returned them to the
        loss), the first gradient as Adam got it (its first moment after
        one step over 1 - b1) and the parameters' change then, and after
        the last step the parameters' change and the moments, read before
        any later step writes over them."""
        from repro_torch.train import trainer as step_module

        t, log = self.trainer, []
        b1 = self.recipe["adam"]["b1"]
        p0 = _leaves_copy(t.params)
        # the first step's outputs, read where the step's loss takes them
        apply, seen = step_module.chgnet_apply, []

        def observed(*args, **kwargs):
            pred = apply(*args, **kwargs)
            if not seen:
                seen.append({k: pred[k].detach().clone()
                             for k in ref_train.TARGETS})
            return pred

        step_module.chgnet_apply = observed
        try:
            hist = t.train(self.feed.take(1, log))
        finally:
            step_module.chgnet_apply = apply
        if not seen:
            raise RuntimeError("the training step did not call chgnet_apply")
        real = {"energy": log[0]["crystals"], "stress": log[0]["crystals"],
                "forces": log[0]["atoms"], "magmom": log[0]["atoms"]}
        outputs = {k: x[:real[k]] for k, x in seen[0].items()}
        grad = [m / (1 - b1) for m in _leaves_copy(t.opt_state["mu"])]
        delta_first = [p - q for p, q in zip(_leaves_copy(t.params), p0)]
        hist += t.train(self.feed.take(CHECKED_STEPS - 2, log))
        t0 = time.perf_counter()
        hist += t.train(self.feed.take(1, log))
        self.last_step_s = time.perf_counter() - t0
        self.first_rows = log
        self.times["first_steps"] = time.perf_counter()
        return {"metrics": hist, "outputs": outputs, "grad": grad,
                "delta_first": delta_first,
                "delta": [p - q for p, q in
                          zip(_leaves_copy(t.params), p0)],
                "mu": _leaves_copy(t.opt_state["mu"]),
                "nu": _leaves_copy(t.opt_state["nu"])}

    def warm_buckets(self, steps: int) -> set:
        """One step on each ladder bucket that the next ``steps`` batches
        reach and the first steps did not: the batch that first reaches
        it, packed as the iterator packs it.  Returns the buckets warmed
        or run."""
        from repro_torch.data import LoadBalanceSampler, build_device_batch

        twin = LoadBalanceSampler(self.ds.feature_counts(),
                                  self.seeds["sampler"])
        atoms = np.array([c.num_atoms for c in self.ds.crystals])
        bonds = np.array([g.num_bonds for g in self.ds.graphs])
        angles = np.array([g.num_angles for g in self.ds.graphs])
        batch = self.spec["mix"]["batch"]
        seen = {_caps(r) for r in self.first_rows}
        todo, k = {}, 0
        while k < steps:
            for _, shards in twin.epoch(batch, 1):
                idx = shards[0]
                caps = self.ladder.bucket_for(int(atoms[idx].sum()),
                                              int(bonds[idx].sum()),
                                              int(angles[idx].sum()))
                key = (caps.atoms, caps.bonds, caps.angles)
                if key not in seen and key not in todo:
                    todo[key] = (idx, caps)
                k += 1
        for idx, caps in todo.values():
            b = build_device_batch(self.ds, idx, caps,
                                   num_crystal_slots=batch)
            self.trainer.train([b])
        self.times["warm_up"] = time.perf_counter()
        self.buckets = sorted(seen | set(todo))
        return seen | set(todo)

    def report(self) -> str:
        """Seconds of each set-up phase, and the buckets run."""
        t = list(self.times.items())
        phases = ", ".join(f"{k} {b - a:.2f} s"
                           for (_, a), (k, b) in zip(t, t[1:]))
        return f"set-up: {phases}; buckets {self.buckets}"

    def close(self):
        self.feed.close()


def _caps(rows: dict) -> tuple:
    return (rows["atom_cap"], rows["bond_cap"], rows["angle_cap"])


def reference_readings(spec: dict, init: dict, crystals: list,
                       batches: list, device: str,
                       tf32: bool = False) -> tuple[dict, int]:
    """The reference's replay of the first steps on ``batches`` (lists of
    crystal indices), from its own graphs of the crystals, and the count
    of entries of the program's packed ``first`` batches (host arrays, or
    None) that differ from those graphs."""
    model = spec["config"]["model"]
    cache, graphs = {}, []
    for idx in batches:
        for i in idx:
            if i not in cache:
                c = crystals[i]
                cache[i] = ref_graph.crystal_graph(
                    c["lattice"], c["frac"], model["r_cut_atom"],
                    model["r_cut_bond"])
        graphs.append(ref_graph.concat([crystals[i] for i in idx],
                                       [cache[i] for i in idx]))
    recipe = train_recipe(spec["config"], spec["mix"])
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        readings = ref_train.replay(
            init, model, recipe, recipe["total_steps"],
            [ref_model.device_graph(g, device) for g in graphs], tf32=tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    return readings, graphs


def numbers(program: dict, reference: dict, first_batches: list,
            graphs: list) -> dict:
    """Every number compared, by name."""
    mism = sum(sum(ref_graph.batch_mismatches(b, g).values())
               for b, g in zip(first_batches, graphs))
    return dict(graph=mism, **ref_train.compare(program, reference))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is the port)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_info(device: str) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def peaks_for(kind: str):
    for entry in _json(BENCH / "peaks.json").values():
        if entry["match"] in kind:
            return entry
    return None


def run(spec: dict, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_start: float | None = None,
        fault: str | None = None, log=None) -> dict:
    """One run of the cell ``spec`` (``cell_spec``).  Returns the result
    line as a dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = sys.stderr if log is None else log
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device == "cuda"
    prog = Program(spec, seed, device, fault)
    try:
        readings = prog.first_steps()
        # the steps a window can reach: at twice the pace of the last
        # checked step, and a few more
        horizon = CHECKED_STEPS + int(2 * seconds / prog.last_step_s) + 16
        warmed = prog.warm_buckets(horizon)
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        pf = prog.feed.prefetcher
        wait0 = pf.stats["wait_s"]
        setup_s = time.perf_counter() - t_start
        rows, draws = [], []
        prog.trainer.train(prog.feed.window(seconds, rows, draws))
        wait_s = pf.stats["wait_s"] - wait0
        if cuda:
            torch.cuda.synchronize()
            window_peak = torch.cuda.max_memory_allocated()
        else:
            setup_peak = window_peak = 0
        step_ms = np.diff(draws) * 1e3
        print(f"perfbench: {prog.report()}; window {len(rows)} steps, ms "
              f"median {np.median(step_ms):.1f} p95 "
              f"{np.percentile(step_ms, 95):.1f} max {step_ms.max():.1f}; "
              f"crystals/s by thirds "
              f"{_by_thirds(rows, draws)}",
              file=log)
        unwarmed = {_caps(r) for r in rows} - warmed
        if unwarmed:
            print(f"perfbench: buckets not warmed: {sorted(unwarmed)}",
                  file=log)
        traced = _traced_steps(prog, spec, cuda) if trace else None
    finally:
        prog.close()
    window_s = draws[-1] - draws[0]
    kind = device_info(device)["kind"]
    ctx = {"model": spec["config"]["model"], "peaks": peaks_for(kind),
           "window": {"seconds": window_s, "rows": rows, "wait_s": wait_s},
           "trace": traced,
           "kernels": lambda k: load_file(BENCH / "kernels" / f"{k}.py")}
    values = {
        "setup_s": setup_s,
        "train_crystals_per_s": sum(r["crystals"] for r in rows) / window_s,
        "train_step_ms_p95": float(np.percentile(step_ms, 95)),
        "peak_mem_gib": window_peak / 2**30,
    }
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        if trace:
            v = load_file(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
        else:
            v = values[m["name"]]
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = dict(device_info(device),
               memory_peak_bytes=int(max(setup_peak, window_peak)))
    result = {"attempted": len(rows), "failed": 0, "metrics": metrics,
              "device": dev}
    if traced is not None and traced["trace"]["device"]:
        lo, hi = traced["trace"]["window"]
        dev["busy_s"] = devtrace.busy_us(traced["trace"]) * 1e-6
        dev["window_s"] = (hi - lo) * 1e-6
        result["breakdown"] = devtrace.breakdown(traced["trace"])
    init, crystals = prog.init, prog.crystals
    first_batches, first_idx = prog.first_batches, prog.first_indices
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference, graphs = reference_readings(spec, init, crystals, first_idx,
                                           device)
    nums = numbers(readings, reference, first_batches, graphs)
    print(f"perfbench: reference {time.perf_counter() - t_ref:.2f} s",
          file=log)
    result["correct"] = judge(nums, spec["limits"])
    result["checks"] = {k: {"value": nums[k], "limit": lim}
                        for k, lim in spec["limits"].items()}
    return result


def _by_thirds(rows: list, draws: list) -> list[float]:
    """The window's rate in each third of its steps (drift shows here)."""
    cut = [len(rows) * k // 3 for k in range(4)]
    return [round(sum(r["crystals"] for r in rows[a:b])
                  / (draws[b] - draws[a]), 1)
            for a, b in zip(cut, cut[1:]) if b > a]


def judge(nums: dict, limits: dict) -> bool:
    """Every number that the cell's limits name is finite and within its
    limit (a number that they do not name is not compared)."""
    return all(math.isfinite(nums[k]) and nums[k] <= lim
               for k, lim in limits.items())


def _traced_steps(prog: Program, spec: dict, cuda: bool) -> dict:
    """Profile the steps that follow the window, for about the mix's
    ``trace_seconds``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    log = []
    with torch.profiler.profile(activities=acts) as prof:
        prog.trainer.train(prog.feed.traced(spec["mix"]["trace_seconds"],
                                            log))
        if cuda:
            torch.cuda.synchronize()
    print(f"perfbench: traced {len(log)} steps", file=sys.stderr)
    return {"trace": devtrace.collect(prof), "rows": log}


def emit(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """Print a run's result: each number compared beside its limit as the
    last lines on standard error, then the result line, ``checks`` last,
    as the last line on standard output."""
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=err)
    line = {k: result[k] for k in
            ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    print(json.dumps(line), file=out, flush=True)
