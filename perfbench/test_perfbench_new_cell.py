"""A cell added by new files only: in a temporary copy of the benchmark,
a configuration whose driver and reference this test writes (a tiny
per-atom energy model in plain PyTorch, trained by SGD, and a reference
that loops over the crystals one by one), a mix, a limits file and one
per-layer metric.  A fresh interpreter whose ``perfbench`` is the copy
runs the cell through ``cell_spec``, ``run`` and ``emit``: ``correct``
holds, the driver's planted fault fails it, and no file of this
repository's ``perfbench/`` is written."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

from perfbench import harness

CELL = "toy_energy.toy_pool"
METRIC = "toy.atoms_per_step.train"

CONFIG = {
    "name": "toy_energy", "source": "https://arxiv.org/abs/2302.14231",
    "what": "a per-atom energy model: tanh(emb[z] x W + b) . w, summed "
            "over each crystal's atoms; squared error, SGD",
    "model": {"dim": 8, "elements": 6, "precision": "f32"},
    "train": {"lr": 0.05},
    "reference": "reference/toy_energy.py",
    "driver": "drivers/toy_energy_train.py",
}
MIX = {"pool": 12, "batch": 3, "sizes": {"min_atoms": 2, "max_atoms": 5},
       "trace_seconds": 0.1}
LIMITS = {"loss": 1e-4, "update": 1e-4}

REFERENCE = '''
"""The toy model one crystal at a time: its energy, the batch's mean
squared error, and SGD steps."""
import torch


def energy(params, z, x):
    h = torch.tanh(params["emb"][z] * x[:, None] @ params["w"]
                   + params["b"])
    return (h @ params["out"]).sum()


def replay(init, crystals, batches, lr):
    """One SGD step on each batch (lists of crystal indices); each step's
    loss and the parameters' change after the last."""
    p = {k: v.clone().requires_grad_() for k, v in init.items()}
    losses = []
    for idx in batches:
        errs = [energy(p, *crystals[i][:2]) - crystals[i][2] for i in idx]
        loss = sum(e * e for e in errs) / len(idx)
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for v, g in zip(p.values(), grads):
                v -= lr * g
        losses.append(float(loss.detach()))
    return losses, {k: v.detach() - init[k] for k, v in p.items()}
'''

DRIVER = '''
"""The toy model's driver: crystals packed into one padded batch, the
energy by an index_add over the atoms."""
import collections
import time

import numpy as np
import torch

from perfbench import harness

CHECKED_STEPS = 2
CHECKS = ("loss", "update")


def shape(rows):
    return rows["atom_cap"]


class _Source:
    def __init__(self, gen):
        self.gen, self.stats = gen, {"wait_s": 0.0}

    def __iter__(self):
        return self.gen


class Program:
    def __init__(self, spec, seed, device, fault=None):
        self.times = {"start": time.perf_counter()}
        model, mix = spec["config"]["model"], spec["mix"]
        s = harness.seeds(seed)
        rng = np.random.default_rng(s["data"])
        lo, hi = mix["sizes"]["min_atoms"], mix["sizes"]["max_atoms"]
        self.crystals = []
        for _ in range(mix["pool"]):
            n = int(rng.integers(lo, hi + 1))
            self.crystals.append((
                torch.as_tensor(rng.integers(0, model["elements"], n)),
                torch.as_tensor(rng.standard_normal(n), dtype=torch.float32),
                float(rng.standard_normal())))
        gen = torch.Generator(device).manual_seed(s["params"])
        d, e = model["dim"], model["elements"]
        self.params = {k: 0.5 * torch.randn(*dims, generator=gen,
                                            device=device)
                       for k, dims in (("emb", (e, d)), ("w", (d, d)),
                                       ("b", (d,)), ("out", (d,)))}
        self.init = {k: v.clone() for k, v in self.params.items()}
        self.lr, self.cap = spec["config"]["train"]["lr"], mix["batch"] * hi
        order = np.random.default_rng(s["sampler"]).permutation(mix["pool"])
        batches = order.reshape(-1, mix["batch"])
        self.first_indices, rows = [], collections.deque()

        def source():
            while True:
                for idx in batches:
                    if len(self.first_indices) < CHECKED_STEPS:
                        self.first_indices.append(idx.tolist())
                    if fault == "half_batch":
                        idx = idx[:len(idx) // 2]
                    b = self._pack(idx, device)
                    rows.append({"crystals": len(idx),
                                 "atoms": int(b["mask"].sum()), "bonds": 0,
                                 "angles": 0, "atom_cap": self.cap,
                                 "bond_cap": 0, "angle_cap": 0})
                    yield b

        self.feed = harness.Feed(_Source(source()), rows)
        self.times["set_up"] = time.perf_counter()

    def _pack(self, idx, device):
        z = torch.zeros(self.cap, dtype=torch.long)
        x = torch.zeros(self.cap)
        seg = torch.zeros(self.cap, dtype=torch.long)
        mask = torch.zeros(self.cap)
        at = 0
        for k, i in enumerate(idx):
            zi, xi, _ = self.crystals[i]
            z[at:at + len(zi)], x[at:at + len(zi)] = zi, xi
            seg[at:at + len(zi)], mask[at:at + len(zi)] = k, 1.0
            at += len(zi)
        target = torch.tensor([self.crystals[i][2] for i in idx])
        return {k: v.to(device) for k, v in (("z", z), ("x", x),
                ("seg", seg), ("mask", mask), ("target", target))}

    def train(self, items):
        losses = []
        for b in items:
            p = {k: v.requires_grad_() for k, v in self.params.items()}
            h = torch.tanh(p["emb"][b["z"]] * b["x"][:, None] @ p["w"]
                           + p["b"])
            atom = (h @ p["out"]) * b["mask"]
            e = torch.zeros(len(b["target"]), device=atom.device)
            e = e.index_add(0, b["seg"], atom)
            loss = ((e - b["target"]) ** 2).mean()
            grads = torch.autograd.grad(loss, list(p.values()))
            with torch.no_grad():
                self.params = {k: v - self.lr * g for (k, v), g
                               in zip(p.items(), grads)}
            losses.append(float(loss.detach()))
        return losses

    def first_steps(self):
        log = []
        losses = self.train(self.feed.take(CHECKED_STEPS - 1, log))
        t0 = time.perf_counter()
        losses += self.train(self.feed.take(1, log))
        self.last_step_s = time.perf_counter() - t0
        self.first_rows = log
        return {"losses": losses, "delta": {k: v - self.init[k] for k, v
                                            in self.params.items()}}

    def warm_buckets(self, steps):
        return {shape(r) for r in self.first_rows}

    def report(self):
        return f"set-up {self.times['set_up'] - self.times['start']:.3f} s"

    def evidence(self):
        return {"init": self.init, "crystals": self.crystals,
                "batches": self.first_indices}

    def close(self):
        self.feed.close()


def check(spec, evidence, readings, device):
    ref = harness.module_at(spec["bench"], spec["config"]["reference"])
    crystals = [(z.to(device), x.to(device), t)
                for z, x, t in evidence["crystals"]]
    losses, delta = ref.replay(evidence["init"], crystals,
                               evidence["batches"],
                               spec["config"]["train"]["lr"])
    gap = max(abs(a - b) / abs(b) for a, b in zip(readings["losses"], losses))
    num = sum(float((readings["delta"][k] - d).norm() ** 2)
              for k, d in delta.items())
    den = sum(float(d.norm() ** 2) for d in delta.values())
    return {"loss": gap, "update": (num / den) ** 0.5}
'''

READER = '''
"""Real atoms a step in the window."""


def read(ctx):
    rows = ctx["window"]["rows"]
    return sum(r["atoms"] for r in rows) / len(rows) if rows else None
'''

PROBE = r"""
import io, json, sys
from pathlib import Path
from perfbench import harness
root = Path(sys.argv[1])
spec = harness.cell_spec(sys.argv[2], root)
lines = []
for trace in (False, True):
    out, err = io.StringIO(), io.StringIO()
    harness.emit(harness.run(spec, 2**31 + 21, 0.2, trace, device="cpu",
                             log=err), out, err)
    lines.append(json.loads(out.getvalue().strip().splitlines()[-1]))
bad = harness.run(spec, 2**31 + 21, 0.2, False, device="cpu",
                  fault="half_batch", log=io.StringIO())
print(json.dumps({"lines": lines, "fault": bad["correct"],
                  "fault_checks": bad["checks"],
                  "harness": harness.__file__,
                  "driver": harness.driver(spec).__file__}))
"""


def _snapshot(top) -> dict:
    """Every file under ``top`` but compiled bytecode, by its digest."""
    return {p.relative_to(top).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(top.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_by_new_files_runs_and_is_judged(tmp_path):
    before = _snapshot(harness.BENCH)
    root = tmp_path / "checkout"
    bench_dir = root / "perfbench"
    shutil.copytree(harness.BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_energy",
                             "source": CONFIG["source"],
                             "file": "perfbench/configs/toy_energy.json",
                             "reduced": [], "why": "a test's toy model"})
    bench["workloads"].append({"name": CELL, "config": "toy_energy",
                               "traffic": "toy_pool", "chips": 1,
                               "why": "a test's toy traffic"})
    # an end-to-end metric kept to some cells names the new one too
    for m in bench["end_to_end"]:
        if m["name"] == "train_crystals_per_s" and "workloads" in m:
            m["workloads"].append(CELL)
    bench["per_layer"].append({"name": METRIC, "unit": "atoms/step",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "the toy driver's batches",
                               "moves": "train_crystals_per_s",
                               "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    new = {"configs/toy_energy.json": json.dumps(CONFIG),
           "mixes/toy_pool.json": json.dumps(MIX),
           f"limits/{CELL}.json": json.dumps(LIMITS),
           f"metrics/{METRIC}.py": READER,
           "reference/toy_energy.py": REFERENCE,
           "drivers/toy_energy_train.py": DRIVER}
    for rel, text in new.items():
        assert not (bench_dir / rel).exists(), rel
        (bench_dir / rel).write_text(textwrap.dedent(text).lstrip())
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", PROBE, str(root), CELL],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    # the copy's harness ran the copy's driver
    assert got["harness"].startswith(str(bench_dir))
    assert got["driver"] == str(bench_dir / "drivers/toy_energy_train.py")
    plain, traced = got["lines"]
    assert plain["correct"] and traced["correct"], got
    assert set(plain["metrics"]) == {"train_crystals_per_s", "peak_mem_gib",
                                     "setup_s"}
    assert traced["metrics"][METRIC]["value"] >= 2
    assert list(plain["checks"]) == list(LIMITS)
    assert not got["fault"], got["fault_checks"]
    # nothing written: neither here nor over the copy's existing files
    assert _snapshot(harness.BENCH) == before
    copied = _snapshot(bench_dir)
    assert {k: copied[k] for k in before} == before
