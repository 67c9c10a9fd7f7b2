"""Production dry run of the port: every (arch x shape) cell on the
single-pod 16x16 mesh and the 2x16x16 multi-pod mesh, plus the CHGNet
cell, built on the ``meta`` device (PyTorch port of
``repro.launch.dryrun``).

Each cell is built by ``launch.steps.build_cell`` (the CHGNet cell from
``train.trainer``'s pieces) on ``launch.mesh.make_production_mesh``,
whose 256 / 512 positions stand for H100s.  A record holds:

  - ``status`` (``configs.shapes.cell_status``) and ``accum_steps``;
  - ``bytes``: the global and per-rank bytes of the parameters, the
    optimizer state, the inputs and the decode state (prefill: the cache
    it returns; decode: the state it reads).  Per-rank bytes are each
    leaf's bytes divided by the sizes of the mesh axes its spec tuple
    names: JAX's layout, which the port does not execute (its multi-rank
    layouts are DP replicas and GPipe stages);
  - ``memory.argument_bytes`` (their per-rank sum) and ``fits_80gb``, on
    those argument bytes alone (80e9 bytes of HBM3 a card);
  - ``analytic``: FLOPs, HBM bytes and collective bytes a chip from
    ``analysis.roofline``'s models, and the roofline's accum steps;
  - ``grad_allreduce``: the bucketed gradient all-reduce that
    ``distributed.collectives.bucket_plan`` gives the parameter leaves
    (train cells): buckets, bytes, and the ring traffic a rank over the
    DP extent.  This stands where JAX's ``collective_stats`` parses the
    compiled HLO.

The port compiles nothing, so JAX's ``temp_bytes``, ``output_bytes``,
``alias_bytes``, ``cost`` and HLO collective fields are ``None``, with
``null_reason`` "no compiler artifact" (``collective_stats`` and
``_shape_bytes``, which parse XLA's HLO text, have no counterpart).
Everything runs on ``meta``, in seconds, and touches no device (the
CHGNet cell's 1.7 MB tree is drawn on the CPU, then read as ``meta``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh single,multi
Records go to build/dryrun/dryrun.json (one a cell, replaced by key).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.analysis import roofline
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import (
    SHAPES,
    cell_status,
    decode_state_structs,
)
from repro_torch.distributed.collectives import bucket_plan
from repro_torch.launch.mesh import make_production_mesh, mesh_sizes
from repro_torch.launch.steps import build_cell
from repro_torch.optim.tree import leaves

OUT_DIR = os.path.join(os.path.dirname(__file__), "../../../build/dryrun")
HBM_BYTES = 80e9            # an H100 SXM's HBM3 (datasheet)
BUCKET_BYTES = 4 << 20      # collectives.bucket_plan's default
NULL_REASON = "no compiler artifact"
CHGNET_ARCH, CHGNET_SHAPE = "chgnet-fastchgnet", "train_b2048"


def _pairs(tree, specs):
    """(leaf, spec tuple) pairs of a tree and its spec tree."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)):
        for t, s in zip(tree, specs):
            yield from _pairs(t, s)
    else:
        yield tree, specs


def leaf_bytes(t) -> int:
    return t.numel() * t.element_size()


def spec_divisor(spec, sizes: dict) -> int:
    """The number of ranks a leaf is split over: the product of the sizes
    of the axes its spec tuple names."""
    n = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                n *= sizes[a]
    return n


def tree_bytes(tree, specs=None, sizes=None) -> dict:
    """Global bytes of a tree's leaves and bytes a rank under ``specs``
    (each leaf's bytes over its spec's divisor; replicated if no specs)."""
    if specs is None:
        total = sum(leaf_bytes(t) for t in leaves(tree))
        return {"global": total, "per_rank": total}
    pairs = list(_pairs(tree, specs))
    return {"global": sum(leaf_bytes(t) for t, _ in pairs),
            "per_rank": sum(leaf_bytes(t) / spec_divisor(s, sizes)
                            for t, s in pairs)}


def grad_allreduce(params, dp_total: int) -> dict:
    """The bucketed all-reduce of f32 gradients like ``params`` over
    ``dp_total`` replicas: ``bucket_plan``'s buckets and the ring's
    2 (n - 1) / n bytes a rank."""
    flat = leaves(params)
    plan = bucket_plan(flat, BUCKET_BYTES)
    sizes = [sum(flat[i].numel() * 4 for i in b) for b in plan]
    total = sum(sizes)
    return {"bucket_bytes": BUCKET_BYTES, "buckets": len(plan),
            "leaves": len(flat), "bytes": total,
            "largest_bucket_bytes": max(sizes),
            "ring_bytes_per_rank": 2.0 * (dp_total - 1) / dp_total * total}


def _memory(arg_bytes: float) -> dict:
    return {"argument_bytes": arg_bytes, "output_bytes": None,
            "temp_bytes": None, "alias_bytes": None,
            "peak_per_device_bytes": None}


def _null_fields() -> dict:
    return {"cost": {"flops": None, "bytes_accessed": None},
            "collectives": None, "null_reason": NULL_REASON}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             attn_chunk: int = 1024) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16", "kind": shape.kind}
    status = cell_status(cfg, shape)
    if status != "ok":
        rec["status"] = status
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = mesh_sizes(mesh)
    chips, model_par = mesh.size, sizes["model"]
    dp_total = chips // model_par
    t0 = time.time()
    try:
        step, args, specs, donate, out_specs = build_cell(
            cfg, shape, mesh, multi_pod=multi_pod, attn_chunk=attn_chunk)
        b = {"params": tree_bytes(args[0], specs[0], sizes)}
        if shape.kind == "train":
            b["opt_state"] = tree_bytes(args[1], specs[1], sizes)
            b["inputs"] = tree_bytes(args[2:], specs[2:], sizes)
            b["decode_state"] = {"global": 0, "per_rank": 0}
        elif shape.kind == "prefill":
            state, state_spec = decode_state_structs(
                cfg, shape.batch, shape.seq, multi_pod=multi_pod,
                mesh_sizes=sizes)
            b["opt_state"] = {"global": 0, "per_rank": 0}
            b["inputs"] = tree_bytes(args[1:], specs[1:], sizes)
            b["decode_state"] = tree_bytes(state, state_spec, sizes)
        else:
            b["opt_state"] = {"global": 0, "per_rank": 0}
            b["inputs"] = tree_bytes((args[1],) + args[3:],
                                     (specs[1],) + specs[3:], sizes)
            b["decode_state"] = tree_bytes(args[2], specs[2], sizes)
        arg_bytes = sum(v["per_rank"] for v in b.values())
        accum = roofline.roofline_accum(cfg, shape, dp_total)
        ana = roofline.analytic_flops(cfg, shape)
        rec.update({
            "status": "ok",
            "build_s": round(time.time() - t0, 3),
            "accum_steps": getattr(step, "accum_steps", None),
            "donate": list(donate),
            "bytes": b,
            "memory": _memory(arg_bytes),
            "fits_80gb": arg_bytes <= HBM_BYTES,
            "analytic": {
                "accum": accum,
                "flops_per_chip": ana["flops"] / chips,
                "model_flops": ana["model_flops"],
                "hbm_bytes_per_chip": roofline.analytic_bytes(
                    cfg, shape, chips=chips, model_par=model_par,
                    dp_total=dp_total, accum=accum),
                "collective_bytes_per_chip":
                    roofline.analytic_collective_bytes(
                        cfg, shape, chips=chips, model_par=model_par,
                        dp_total=dp_total, accum=accum),
            },
            "grad_allreduce": grad_allreduce(args[0], dp_total)
            if shape.kind == "train" else None,
            **_null_fields(),
        })
    except Exception as exc:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = f"error: {type(exc).__name__}: {exc}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def run_chgnet_cell(multi_pod: bool, global_batch: int = 2048) -> dict:
    """The paper's own model at production scale: FastCHGNet DP training
    (``FAST_FS_HEAD``) at batch 2048 over every position of the mesh,
    one replica a rank, at JAX's per-device capacities (MPtrj-like: ~32
    atoms, ~900 bonds, ~1100 angles a crystal, P99 + margin)."""
    from repro_torch.batching import BatchCapacities
    from repro_torch.configs import chgnet_mptrj as C
    from repro_torch.configs.shapes import to_meta
    from repro_torch.core.chgnet import chgnet_init
    from repro_torch.core.graph import batch_input_specs
    from repro_torch.optim.adam import adam_init

    rec = {"arch": CHGNET_ARCH, "shape": f"train_b{global_batch}",
           "mesh": "2x16x16" if multi_pod else "16x16", "kind": "train"}
    mesh = make_production_mesh(multi_pod=multi_pod)
    ndev = mesh.size
    per_dev = global_batch // ndev
    caps = BatchCapacities(atoms=64 * per_dev, bonds=1536 * per_dev,
                           angles=2048 * per_dev)
    t0 = time.time()
    try:
        params = to_meta(chgnet_init(0, C.FAST_FS_HEAD))
        opt = to_meta(adam_init(params))
        batch = batch_input_specs(per_dev, caps)
        from repro_torch.core.graph import FIELDS
        inputs = [getattr(batch, k) for k in FIELDS]
        b = {"params": tree_bytes(params), "opt_state": tree_bytes(opt),
             "inputs": tree_bytes(inputs),
             "decode_state": {"global": 0, "per_rank": 0}}
        for k in ("params", "opt_state"):   # replicas
            b[k]["global"] *= ndev
        b["inputs"]["global"] *= ndev       # one shard a rank
        arg_bytes = sum(v["per_rank"] for v in b.values())
        rec.update({
            "status": "ok", "build_s": round(time.time() - t0, 3),
            "accum_steps": 1, "per_device_batch": per_dev,
            "capacities": {"atoms": caps.atoms, "bonds": caps.bonds,
                           "angles": caps.angles},
            "bytes": b, "memory": _memory(arg_bytes),
            "fits_80gb": arg_bytes <= HBM_BYTES,
            "analytic": None,
            "analytic_reason": "the roofline's analytic models cover the "
                               "LM archs only, as JAX's",
            "grad_allreduce": grad_allreduce(params, ndev),
            **_null_fields(),
        })
    except Exception as exc:  # noqa: BLE001
        rec["status"] = f"error: {type(exc).__name__}: {exc}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id or comma list")
    ap.add_argument("--shape", default=None, help="shape name or comma list")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--attn-chunk", type=int, default=1024)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else args.arch.split(",")
    shapes = list(SHAPES) if (args.all or not args.shape) \
        else args.shape.split(",")
    meshes = args.mesh.split(",")
    run_chgnet = args.all or (args.arch and "chgnet" in args.arch)
    archs = [a for a in archs if a != "chgnet"]

    out_path = args.out or os.path.normpath(
        os.path.join(OUT_DIR, "dryrun.json"))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    records = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            records = json.load(f)

    def put(rec):
        key = (rec["arch"], rec["shape"], rec["mesh"])
        records[:] = [r for r in records
                      if (r["arch"], r["shape"], r["mesh"]) != key]
        records.append(rec)
        arg = (rec.get("memory") or {}).get("argument_bytes")
        print(f"== {key[0]} x {key[1]} x {key[2]} -> {rec['status']}"
              + (f" args/rank={arg / 2**30:.2f}GiB" if arg else ""),
              flush=True)

    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                put(run_cell(arch, shape, mesh_kind == "multi",
                             args.attn_chunk))
    if run_chgnet:
        for mesh_kind in meshes:
            put(run_chgnet_cell(mesh_kind == "multi"))
    with open(out_path, "w") as f:
        json.dump(records, f, indent=1)
    print(f"wrote {out_path} ({len(records)} records)")
    return 0 if all(r["status"] == "ok" or r["status"].startswith("skip")
                    for r in records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
