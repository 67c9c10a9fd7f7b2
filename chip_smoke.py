#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's FastCHGNet serving path (``configs.chgnet_mptrj.
FAST_FUSED`` at full width, random weights from ``--seed``) through its
public entry points, ``ServeEngine`` and ``BatchedMD``, and holds every
hand-written CUDA kernel of that path against its plain PyTorch version:

  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: the kernels compile from ``src/repro_torch/csrc`` (nvcc);
  3. kernels: each kernel against its plain version on the card, on the
     inputs of a real packed serving batch, within
     ``1e-4 * max(1, max|plain|)``, and both timed with CUDA events;
  4. serve: one warm-up MD step, then 5 steps of 16 replicas; the launch
     counters must show every kernel on the path,
     the outputs must be finite, and one batch through the plain path
     (the unfused model, no kernel) must agree with the kernels' path.

Prints a ``{"kernels": [...]}`` and a ``{"serve": {...}}`` JSON line and,
last, ``{"ok": true, "device": {...}}``.  Any failure raises and exits
nonzero; without CUDA it exits nonzero before printing a result.

    python3 chip_smoke.py [--seed 0] [--profile DIR]
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.batching import batch_crystals  # noqa: E402
from repro_torch.configs import chgnet_mptrj  # noqa: E402
from repro_torch.core import chgnet, heads  # noqa: E402
from repro_torch.core.neighbors import build_graph  # noqa: E402
from repro_torch.data import SyntheticConfig, generate_crystal  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.serve import BatchedMD, ServeEngine  # noqa: E402

REPLICAS = 16
STEPS = 5
# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SOURCE = "src/repro_torch/csrc/message_passing.cu"
TPU_FILE = "src/repro/kernels/fused_message_passing.py"
PER_FORWARD = {"fused_atom_conv": 4, "fused_bond_conv": 3,
               "fused_force_readout": 1}


def _time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event samples of ``inner`` back-to-back
    calls each, per call, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / inner)
    return statistics.median(samples)


def _slots(n: int) -> int:
    """Crystal slots of a group of n replicas: the next power of two."""
    return 1 << max(0, (n - 1).bit_length())


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _check_close(name: str, got: torch.Tensor,
                 want: torch.Tensor) -> tuple[float, float]:
    """Max abs error of ``got`` against ``want`` and the tolerance it met,
    ``1e-4 * max(1, max|want|)``; raises if it did not."""
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite values")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    tol = 1e-4 * max(1.0, want.abs().max().item() if want.numel() else 0.0)
    if not err <= tol:
        raise RuntimeError(f"{name}: max abs error {err} > {tol}")
    return err, tol


def kernel_phase(params, cfg, batch):
    """Each kernel against its plain version on one real packed batch."""
    with torch.inference_mode():
        v, e, a, e_a, e_b, vec, dist = chgnet.embed(params, cfg, batch)
    blk = params["blocks"][0]
    am, bm = blk["atom_mlp"], blk["bond_mlp"]
    (l0, l1) = params["force_head"]["mlp"]
    center = batch.bond_center[batch.angle_ij]
    x_hat = heads.bond_unit_vectors(vec, dist)
    n_atoms, dim = v.shape
    n_bonds = e.shape[0]
    real_bonds = int(batch.bond_offsets[-1])
    real_angles = int(batch.angle_offsets[-1])
    f = 4  # bytes per f32 / int32 element
    cases = [
        ("atom_conv_fwd", ops.fused_atom_conv, ref.fused_atom_conv_ref,
         (v, e, e_a, am["w"], am["b"], am["ln_scale"], am["ln_bias"],
          batch.bond_center, batch.bond_nbr, batch.bond_offsets),
         f"{TPU_FILE}:252",
         2 * real_bonds * 3 * dim * 2 * dim,
         f * (n_atoms * dim + 2 * real_bonds * dim + 3 * dim * 2 * dim
              + 6 * dim + 2 * real_bonds + n_atoms + 1 + n_atoms * dim),
         {"atoms": n_atoms, "bonds": n_bonds, "real_bonds": real_bonds,
          "dim": dim}),
        ("bond_conv_fwd", ops.fused_bond_conv, ref.fused_bond_conv_ref,
         (v, e, a, e_b, bm["w"], bm["b"], bm["ln_scale"], bm["ln_bias"],
          batch.angle_ij, batch.angle_ik, center, batch.angle_offsets),
         f"{TPU_FILE}:488",
         2 * real_angles * 4 * dim * 2 * dim,
         f * (n_atoms * dim + 2 * n_bonds * dim + real_angles * dim
              + 4 * dim * 2 * dim + 6 * dim + 3 * real_angles + n_bonds + 1
              + n_bonds * dim),
         {"atoms": n_atoms, "bonds": n_bonds, "angles": a.shape[0],
          "real_angles": real_angles, "dim": dim}),
        ("force_readout_fwd", ops.fused_force_readout,
         ref.fused_force_readout_ref,
         (e, x_hat, l0["w"], l0["b"], l1["w"], l1["b"], batch.bond_center,
          batch.bond_offsets, n_atoms),
         f"{TPU_FILE}:737",
         2 * real_bonds * dim * dim + 2 * real_bonds * dim + 6 * real_bonds,
         f * (real_bonds * (dim + 3) + dim * dim + 2 * dim + 1 + n_atoms + 1
              + n_atoms * 3),
         {"atoms": n_atoms, "bonds": n_bonds, "real_bonds": real_bonds,
          "dim": dim}),
    ]
    rows = []
    with torch.inference_mode():
        for name, kernel, plain, args, replaces, flops, nbytes, shape in cases:
            got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err, tol = _check_close(name, got, want)
            k_ms = _time_ms(lambda: kernel(*args))
            p_ms = _time_ms(lambda: plain(*args))
            bound_ms, bound_by = _bound(flops, nbytes)
            rows.append({
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": replaces, "wrapper": kernel.__name__,
                "max_abs_err": err, "tolerance": tol, "ms": k_ms, "kernel_ms": k_ms,
                "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "flops": flops, "bytes": nbytes,
                "shape": shape,
            })
            print(f"kernel {name}: max|k-p| {err:.3e} (tolerance {tol:.3e}), "
                  f"kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}), shape {shape}", flush=True)
    return rows


def edge_case_phase(seed: int) -> int:
    """Each kernel against its plain version on ragged CSR layouts: a
    padded tail, unaligned rows without padding, every edge padded, and
    several rows per block.  Returns the number of cases checked."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy(
            rng.normal(0, scale, shape).astype(np.float32)).cuda()

    def ids(high, n):
        return torch.from_numpy(
            rng.integers(0, high, n).astype(np.int32)).cuda()

    def csr(rows, n_edges, n_real):
        seg = np.zeros(n_edges, np.int32)
        seg[:n_real] = np.sort(rng.integers(0, rows, n_real))
        offs = np.searchsorted(seg[:n_real], np.arange(rows + 1))
        return (torch.from_numpy(seg).cuda(),
                torch.from_numpy(offs.astype(np.int32)).cuda())

    def mlp(d_in, d):
        return (f(d_in, 2 * d, scale=0.1), f(2 * d),
                f(2 * d).abs() + 0.5, f(2 * d))

    n = 0
    with torch.inference_mode():
        for rows, n_edges, d, n_real, per_block in (
                (16, 200, 32, 180, 1), (9, 64, 64, 64, 3), (8, 32, 16, 0, 1),
                (40, 700, 8, 650, 7)):
            seg, offs = csr(rows, n_edges, n_real)
            args = (f(rows, d), f(n_edges, d), f(n_edges, d)) \
                + mlp(3 * d, d) + (seg, ids(rows, n_edges), offs)
            _check_close(f"atom_conv case {n}", ops.fused_atom_conv(
                *args, block_rows=per_block), ref.fused_atom_conv_ref(*args))
            xh = f(n_edges, 3)
            fargs = (f(n_edges, d), xh / xh.norm(dim=1, keepdim=True),
                     f(d, d, scale=0.1), f(d, scale=0.1),
                     f(d, 1, scale=0.1), f(1, scale=0.1), seg, offs, rows)
            _check_close(f"force_readout case {n}", ops.fused_force_readout(
                *fargs, block_rows=per_block),
                ref.fused_force_readout_ref(*fargs))
            n += 2
        for atoms, bonds, n_ang, d, n_real, per_block in (
                (10, 48, 300, 32, 260, 32), (6, 17, 40, 16, 40, 1),
                (5, 12, 24, 8, 0, 32), (30, 400, 900, 64, 880, 5)):
            seg, offs = csr(bonds, n_ang, n_real)
            args = (f(atoms, d), f(bonds, d), f(n_ang, d), f(bonds, d)) \
                + mlp(4 * d, d) + (seg, ids(bonds, n_ang), ids(atoms, n_ang),
                                   offs)
            _check_close(f"bond_conv case {n}", ops.fused_bond_conv(
                *args, block_rows=per_block), ref.fused_bond_conv_ref(*args))
            n += 1
    torch.cuda.synchronize()
    return n


def serve_breakdown(md, serve) -> dict:
    """One more MD step's serving work taken apart on the host clock:
    neighbor lists, packing, and per group the copy to the card, the
    forward and the copy of the outputs back (which waits for it)."""
    clock = time.perf_counter
    t0 = clock()
    graphs = [r.nlist.update(r.crystal) for r in md.replicas]
    t_nlist = clock() - t0
    t_pack = t_fwd = 0.0
    for bucket, ids in md.groups(graphs):
        slots = _slots(len(ids))
        t0 = clock()
        batch, _ = serve.engine.pack(
            [md.replicas[i].crystal for i in ids], [graphs[i] for i in ids],
            caps=bucket.scaled(slots), num_crystal_slots=slots)
        t_pack += clock() - t0
        t0 = clock()
        out = serve.step_fn(bucket, slots)(batch)
        out["forces"].cpu()
        out["energy"].cpu()
        t_fwd += clock() - t0
    return {"nlist_update_ms": t_nlist * 1e3, "pack_ms": t_pack * 1e3,
            "h2d_forward_d2h_ms": t_fwd * 1e3}


def profile_step(md, out_dir: Path) -> dict:
    """Trace one MD step with torch.profiler: the device time summed over
    kernels, and the kernels that take most of it.  The full table goes
    to ``out_dir/serve_step_profile.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        md.step(1)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    # device-side events only (kernels, copies): the aten:: rows repeat
    # the device time of the kernels they launch
    events = sorted((e for e in averages if e.device_type != DeviceType.CPU
                     and e.self_device_time_total > 0),
                    key=lambda e: -e.self_device_time_total)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "serve_step_profile.txt").write_text(averages.table(
        sort_by="self_device_time_total", row_limit=40))
    return {
        "device_ms": sum(e.self_device_time_total for e in events) / 1e3,
        "device_events": sum(e.count for e in events),
        "top": [{"name": e.key[:60], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3}
                for e in events[:12]],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR",
                    help="also trace one MD step with torch.profiler and "
                         "write its per-kernel device times to DIR")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    print(smi.splitlines()[0], flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.load_libraries()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)

    # serving set-up: full-width FAST_FUSED, 16-64-atom synthetic crystals
    cfg = chgnet_mptrj.FAST_FUSED
    params = chgnet.chgnet_init(args.seed, cfg)
    syn = SyntheticConfig(min_atoms=16, max_atoms=64,
                          lognormal_mu=math.log(40.0), lognormal_sigma=0.4)
    rng = np.random.default_rng(args.seed)
    crystals = [generate_crystal(rng, syn) for _ in range(REPLICAS)]
    t0 = time.perf_counter()
    serve = ServeEngine.for_structures(params, cfg, crystals, device="cuda")
    md = BatchedMD(serve, crystals)
    print(f"set-up: {len(crystals)} replicas of "
          f"{min(c.num_atoms for c in crystals)}-"
          f"{max(c.num_atoms for c in crystals)} atoms, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # the batches the first MD step packs, one per group
    graphs = [build_graph(c, cfg.r_cut_atom, cfg.r_cut_bond)
              for c in crystals]
    probe = []
    for bucket, ids in md.groups(graphs):
        slots = _slots(len(ids))
        b = batch_crystals([crystals[i] for i in ids],
                           [graphs[i] for i in ids], bucket.scaled(slots),
                           num_crystal_slots=slots)
        probe.append(b.to("cuda"))
    group_sizes = [{"atoms": int(b.atom_mask.sum()),
                    "bonds": int(b.bond_offsets[-1]),
                    "angles": int(b.angle_offsets[-1]),
                    "atom_cap": b.atom_cap, "bond_cap": b.bond_cap,
                    "angle_cap": b.angle_cap} for b in probe]
    print(f"groups: {group_sizes}", flush=True)

    # 3. kernels, on the largest group's batch
    big = max(range(len(probe)), key=lambda i: group_sizes[i]["bonds"])
    tree = serve.model.tree()
    rows = kernel_phase(tree, cfg, probe[big])
    print(f"kernels: {edge_case_phase(args.seed)} ragged-layout "
          "cases agree with the plain versions", flush=True)

    # 4. serve: warm-up, then the counted run of the main path
    md.step(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    packed0 = serve.engine.batches_packed
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = md.step(STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = ops.launch_counts()
    forwards = serve.engine.batches_packed - packed0
    for fn, per in PER_FORWARD.items():
        if counts[fn] != per * forwards:
            raise RuntimeError(f"{fn} launched {counts[fn]} times in "
                               f"{forwards} forwards, expected "
                               f"{per * forwards}")
    for row in rows:
        row["launches"] = counts[row["wrapper"]]
    if not (np.isfinite(out["energy"]).all()
            and all(np.isfinite(f).all() for f in out["forces"])):
        raise RuntimeError("serve outputs are not finite")
    peak = torch.cuda.max_memory_allocated()

    # the kernels' path against the plain path (unfused model) on the card
    plain_cfg = cfg.with_(conv_impl="unfused", agg_impl="scatter")
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = serve.model(probe[big])
        want = chgnet.chgnet_apply(tree, plain_cfg, probe[big])
    err_e, tol_e = _check_close("serve energy", got["energy"],
                                want["energy"])
    err_f, tol_f = _check_close("serve forces", got["forces"],
                                want["forces"])
    if ops.launch_counts()["fused_bond_conv"] != PER_FORWARD["fused_bond_conv"]:
        raise RuntimeError("the kernels' path did not launch the kernels")

    # one forward per group on the CUDA-event clock, kernels' path and
    # plain path, then one step taken apart on the host clock
    forward_ms, plain_forward_ms = [], []
    with torch.inference_mode():
        for b in probe:
            forward_ms.append(_time_ms(lambda: serve.model(b), 10, 3))
            plain_forward_ms.append(_time_ms(
                lambda: chgnet.chgnet_apply(tree, plain_cfg, b), 10, 3))
    breakdown = serve_breakdown(md, serve)
    if args.profile:
        prof = breakdown["profile"] = profile_step(md, Path(args.profile))
        # device time of one traced step over the untraced step's wall time
        prof["busy_share"] = prof["device_ms"] / (elapsed / STEPS * 1e3)

    serve_row = {
        "config": "FAST_FUSED", "replicas": len(crystals),
        "steps": STEPS, "forwards": forwards,
        "groups_per_step": forwards / STEPS, "groups": group_sizes,
        "ms_per_batched_step": elapsed / STEPS * 1e3,
        "replica_steps_per_s": len(crystals) * STEPS / elapsed,
        "peak_mem_bytes": peak, "launches": counts,
        "plain_path_max_abs_err": {"energy": err_e, "forces": err_f},
        "plain_path_tolerance": {"energy": tol_e, "forces": tol_f},
        "forward_ms": forward_ms, "plain_forward_ms": plain_forward_ms,
        "breakdown": breakdown, "stats": md.stats(),
    }
    print(f"serve: {serve_row['ms_per_batched_step']:.2f} ms per batched "
          f"step, {serve_row['replica_steps_per_s']:.1f} replica-steps/s, "
          f"peak {peak / 2**20:.1f} MiB, launches {counts}; forward per "
          f"group {forward_ms} ms (plain path {plain_forward_ms} ms); "
          f"one step {breakdown}", flush=True)
    print(json.dumps({"serve": serve_row}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
