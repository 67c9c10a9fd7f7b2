"""One run of one benchmark cell: the timeline, with nothing of the model.

The harness owns the order of a run and every end-to-end number: the
set-up clock from the process's start; the checked first steps; the
warm-up of every shape that the window can reach; the measured window,
whose draws and rows ``Feed`` records; the peak memory; the traced steps
under ``torch.profiler``; ``train_crystals_per_s``, ``train_step_ms_p95``,
``peak_mem_gib`` and ``setup_s`` from those draws and rows; the context
that the per-layer metrics under ``metrics/`` read; freeing the program;
then the check, ``judge`` and ``emit``.

What the program is, how it is set up and fed, and how the reference
checks it belong to the driver that the cell's configuration names
(``"driver"``, a path under ``perfbench/``; ``drivers/__init__.py`` has
the contract).  A cell is added by files alone: a configuration with its
driver and reference, a mix under ``mixes/``, a limits file under
``limits/`` that names the driver's ``CHECKS``, and its metrics'
readers.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import devtrace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_spec(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, mix,
    limits and the metrics it reports, every file read under ``root``;
    ``bench`` is the benchmark's directory there."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r}")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = _json(root / entry["file"])
    for key in ("driver", "reference"):
        if not (root / "perfbench" / config[key]).is_file():
            raise SystemExit(f"perfbench: {entry['file']}: no {key} "
                             f"{config[key]!r}")

    def mine(metric):
        return name in metric.get("workloads", [name])

    return {
        "cell": cell,
        "config": config,
        "bench": root / "perfbench",
        "mix": _json(root / "perfbench" / "mixes" / f"{cell['traffic']}.json"),
        "limits": _json(root / "perfbench" / "limits" / f"{name}.json"),
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


def module_at(bench: Path, rel: str):
    """The module of the file ``rel`` under the benchmark's directory
    ``bench``, imported by its module path (``drivers/chgnet_train.py`` is
    ``perfbench.drivers.chgnet_train``), so that its relative imports
    resolve beside it.  ``bench`` has to be the ``perfbench`` package that
    this process imports."""
    name = "perfbench." + rel.removesuffix(".py").replace("/", ".")
    mod = importlib.import_module(name)
    if Path(mod.__file__).resolve() != (Path(bench) / rel).resolve():
        raise ImportError(f"{name} is {mod.__file__}, not under {bench}")
    return mod


def driver(spec: dict):
    """The driver module that the cell's configuration names."""
    return module_at(spec["bench"], spec["config"]["driver"])


def seeds(seed: int) -> dict:
    """Independent streams for the data, the parameters and the sampler."""
    data, params, sampler = np.random.SeedSequence(seed).generate_state(3)
    return {"data": int(data), "params": int(params),
            "sampler": int(sampler)}


class Feed:
    """The stream the program's timed entry draws from.  ``take(n)``,
    ``window(seconds)`` and ``traced(seconds)`` each hand out the next
    prefetched batches unchanged, and record for each the time of its
    draw and its real rows (in the order the prefetcher keeps).
    ``prefetcher`` is an iterable whose ``stats["wait_s"]`` counts the
    seconds its consumer has waited for it; ``rows`` is the queue in
    which the driver puts each batch's rows as it makes the batch."""

    def __init__(self, prefetcher, rows):
        self._it = iter(prefetcher)
        self._rows = rows
        self.prefetcher = prefetcher

    @property
    def wait_s(self) -> float:
        return self.prefetcher.stats["wait_s"]

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
    drv = driver(spec)
    if set(spec["limits"]) != set(drv.CHECKS):
        raise ValueError(f"limits {sorted(spec['limits'])} are not the "
                         f"CHECKS of {drv.__name__} {sorted(drv.CHECKS)}")
    prog = drv.Program(spec, seed, device, fault)
    try:
        readings = prog.first_steps()
        # the steps a window can reach: at twice the pace of the last
        # checked step, and a few more
        horizon = (len(prog.first_rows) + int(2 * seconds / prog.last_step_s)
                   + 16)
        warmed = prog.warm_buckets(horizon)
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        wait0 = prog.feed.wait_s
        setup_s = time.perf_counter() - t_start
        rows, draws = [], []
        prog.train(prog.feed.window(seconds, rows, draws))
        wait_s = prog.feed.wait_s - wait0
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
        unwarmed = {drv.shape(r) for r in rows} - warmed
        if unwarmed:
            print(f"perfbench: buckets not warmed: {sorted(unwarmed)}",
                  file=log)
        traced = _traced_steps(prog, spec, cuda) if trace else None
    finally:
        prog.close()
    window_s = draws[-1] - draws[0]
    kind = device_info(device)["kind"]
    bench = spec["bench"]
    ctx = {"model": spec["config"]["model"], "peaks": peaks_for(kind),
           "window": {"seconds": window_s, "rows": rows, "wait_s": wait_s},
           "trace": traced,
           "kernels": lambda k: load_file(bench / "kernels" / f"{k}.py")}
    values = {
        "setup_s": setup_s,
        "train_crystals_per_s": sum(r["crystals"] for r in rows) / window_s,
        "train_step_ms_p95": float(np.percentile(step_ms, 95)),
        "peak_mem_gib": window_peak / 2**30,
    }
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        if trace:
            v = load_file(bench / "metrics" / f"{m['name']}.py").read(ctx)
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
    evidence = prog.evidence()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums = drv.check(spec, evidence, readings, device)
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


def _traced_steps(prog, spec: dict, cuda: bool) -> dict:
    """Profile the steps that follow the window, for about the mix's
    ``trace_seconds``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    log = []
    with torch.profiler.profile(activities=acts) as prof:
        prog.train(prog.feed.traced(spec["mix"]["trace_seconds"], log))
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
