"""The driver of the port's CHGNet training (``drivers/__init__.py`` has
the contract).

The entry the window drives is ``repro_torch.train.Trainer.train`` fed by
``Prefetcher(BatchIterator(ds, batch, 1, ladder_for(ds, batch,
num_buckets=...), load_balance=True), device="cuda")``, the one-device
wiring of ``launch/train.train_chgnet``.  The Trainer reads each step's
loss back to the host, so the time between two draws is a step's wall
time.

Set-up: crystals and labels from the seed (``datagen``), the graphs from
the port's ``build_graph``, the parameters from the seed (the reference's
``init_params``) handed to one Trainer, which trains its first three
steps through the window's own feed (the steps the reference follows),
then one step on each ladder bucket that the window will reach and has
not yet run.  The check: the reference that the configuration names
(its model, with the replay and graphs of its package) follows the first
three steps from its own graphs of the same crystals, and ``compare``
gives the numbers.
"""
from __future__ import annotations

import collections
import importlib
import time
import types

import numpy as np
import torch

from perfbench import datagen, harness

# steps the reference follows
CHECKED_STEPS = 3
# the numbers that ``check`` returns
CHECKS = ("graph", "loss", "outputs", "grad", "update", "update_worst",
          "update_first", "moments")


def reference(spec: dict) -> types.SimpleNamespace:
    """The reference of the cell's configuration: the model module that
    its ``reference`` names, and the ``train`` (replay and comparison) and
    ``graph`` modules of the same package."""
    model = harness.module_at(spec["bench"], spec["config"]["reference"])
    package = model.__name__.rpartition(".")[0]
    return types.SimpleNamespace(
        model=model, train=importlib.import_module(f"{package}.train"),
        graph=importlib.import_module(f"{package}.graph"))


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


def shape(rows: dict) -> tuple:
    """The ladder bucket a batch of ``rows`` is packed at."""
    return (rows["atom_cap"], rows["bond_cap"], rows["angle_cap"])


def _leaves_copy(leaves, tree) -> list:
    return [x.detach().clone() for x in leaves(tree)]


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

        self.ref = reference(spec)
        self.spec, self.device = spec, device
        config, mix = spec["config"], spec["mix"]
        self.model = config["model"]
        self.recipe = train_recipe(config, mix)
        self.seeds = harness.seeds(seed)
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

        self.feed = harness.Feed(Prefetcher(
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
        self.init = self.ref.model.init_params(
            self.model, self.seeds["params"], device)
        _check_tree(self.trainer.params, self.init)
        count = sum(x.numel() for x in self.ref.model.leaves(self.init))
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

    def train(self, items) -> list:
        """The timed entry: ``Trainer.train`` over ``items``."""
        return self.trainer.train(items)

    def first_steps(self) -> dict:
        """The first steps through the feed, read as the reference's
        ``replay`` returns them: each step's metrics, the first step's
        outputs at its real rows (as the step's ``chgnet_apply`` returned
        them to the loss), the first gradient as Adam got it (its first
        moment after one step over 1 - b1) and the parameters' change
        then, and after the last step the parameters' change and the
        moments, read before any later step writes over them."""
        from repro_torch.train import trainer as step_module

        t, log = self.trainer, []
        b1 = self.recipe["adam"]["b1"]
        leaves = self.ref.model.leaves
        p0 = _leaves_copy(leaves, t.params)
        # the first step's outputs, read where the step's loss takes them
        apply, seen = step_module.chgnet_apply, []

        def observed(*args, **kwargs):
            pred = apply(*args, **kwargs)
            if not seen:
                seen.append({k: pred[k].detach().clone()
                             for k in self.ref.train.TARGETS})
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
        grad = [m / (1 - b1) for m in _leaves_copy(leaves, t.opt_state["mu"])]
        delta_first = [p - q for p, q in
                       zip(_leaves_copy(leaves, t.params), p0)]
        hist += t.train(self.feed.take(CHECKED_STEPS - 2, log))
        t0 = time.perf_counter()
        hist += t.train(self.feed.take(1, log))
        self.last_step_s = time.perf_counter() - t0
        self.first_rows = log
        self.times["first_steps"] = time.perf_counter()
        return {"metrics": hist, "outputs": outputs, "grad": grad,
                "delta_first": delta_first,
                "delta": [p - q for p, q in
                          zip(_leaves_copy(leaves, t.params), p0)],
                "mu": _leaves_copy(leaves, t.opt_state["mu"]),
                "nu": _leaves_copy(leaves, t.opt_state["nu"])}

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
        seen = {shape(r) for r in self.first_rows}
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

    def evidence(self) -> dict:
        """What the check reads once the program is freed: the initial
        parameters, the crystals, and the first batches as packed and as
        crystal indices."""
        return {"init": self.init, "crystals": self.crystals,
                "first_batches": self.first_batches,
                "first_indices": self.first_indices}

    def close(self):
        self.feed.close()


def reference_readings(spec: dict, init: dict, crystals: list,
                       batches: list, device: str,
                       tf32: bool = False) -> tuple[dict, list]:
    """The reference's replay of the first steps on ``batches`` (lists of
    crystal indices), from its own graphs of the crystals; returns the
    readings and those graphs."""
    ref = reference(spec)
    model = spec["config"]["model"]
    cache, graphs = {}, []
    for idx in batches:
        for i in idx:
            if i not in cache:
                c = crystals[i]
                cache[i] = ref.graph.crystal_graph(
                    c["lattice"], c["frac"], model["r_cut_atom"],
                    model["r_cut_bond"])
        graphs.append(ref.graph.concat([crystals[i] for i in idx],
                                       [cache[i] for i in idx]))
    recipe = train_recipe(spec["config"], spec["mix"])
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        readings = ref.train.replay(
            init, model, recipe, recipe["total_steps"],
            [ref.model.device_graph(g, device) for g in graphs], tf32=tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    return readings, graphs


def numbers(spec: dict, got: dict, want: dict, first_batches: list,
            graphs: list) -> dict:
    """Every number compared, by name: ``graph``, the entries of the
    program's packed first batches that differ from the reference's
    graphs, and ``compare``'s."""
    ref = reference(spec)
    mism = sum(sum(ref.graph.batch_mismatches(b, g).values())
               for b, g in zip(first_batches, graphs))
    return dict(graph=mism, **ref.train.compare(got, want))


def check(spec: dict, evidence: dict, readings: dict, device: str) -> dict:
    """The reference follows the first steps; the numbers compared."""
    ref_readings, graphs = reference_readings(
        spec, evidence["init"], evidence["crystals"],
        evidence["first_indices"], device)
    return numbers(spec, readings, ref_readings, evidence["first_batches"],
                   graphs)


def readings(spec: dict, seed: int, device: str, variants) -> list:
    """[(variant, numbers)] of one seed, in the order of ``variants``, for
    ``calibrate.py``: ``program``, followed by ``program_leaves``
    (``_leaf_look``); ``control``, the reference computed in TF32 in the
    program's place; and a fault of ``Program`` by name (``half_batch``)."""
    prog = Program(spec, seed, device)
    data = (prog.crystals, prog.ds)
    try:
        got = prog.first_steps()
    finally:
        prog.close()
    batches, idx, init = prog.first_batches, prog.first_indices, prog.init
    del prog
    ref, graphs = reference_readings(spec, init, data[0], idx, device)
    out = []
    for variant in variants:
        if variant == "program":
            out.append((variant, numbers(spec, got, ref, batches, graphs)))
            out.append(("program_leaves", _leaf_look(spec, got, ref, init)))
        elif variant == "control":
            ctl, _ = reference_readings(spec, init, data[0], idx, device,
                                        tf32=True)
            out.append((variant, dict(
                graph=0, **reference(spec).train.compare(ctl, ref))))
        else:
            bad = Program(spec, seed, device, variant, data=data)
            try:
                wrong = bad.first_steps()
            finally:
                bad.close()
            out.append((variant, numbers(spec, wrong, ref,
                                         bad.first_batches, graphs)))
    return out


def _paths(tree, at="") -> list:
    """Leaf names in the reference's ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{at}.{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{at}[{i}]")]
    return [at.lstrip(".")]


def _leaf_look(spec: dict, got: dict, ref: dict, init: dict) -> dict:
    """What the change's leaves read besides the numbers compared: the
    90th-percentile leaf, the worst leaf with every element counted, and
    the leaf that ``update_worst`` reads with how many of its elements
    count."""
    train = reference(spec).train
    gaps = train.leaf_gaps(got["delta"], ref["delta"])
    elems = train.element_keep(ref["grad"])
    count = [bool(m.any()) for m in elems]
    masked = train.leaf_gaps([d * m for d, m in zip(got["delta"], elems)],
                             [d * m for d, m in zip(ref["delta"], elems)],
                             count)
    worst = [i for i, c in enumerate(count) if c][int(masked.argmax())]
    return {"update_p90": float(np.percentile(gaps, 90)),
            "update_worst_all": float(gaps.max()),
            "worst_leaf": _paths(init)[worst],
            "worst_leaf_kept": [int(elems[worst].sum()),
                                elems[worst].numel()]}
