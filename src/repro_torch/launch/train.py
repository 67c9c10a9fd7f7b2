"""Training launcher of the PyTorch port, the counterpart of
``repro.launch.train``'s ``--arch chgnet`` mode: FastCHGNet on the
synthetic dataset with the full host side (load-balance or cost-model
sampler, accumulation over capacity buckets, prefetch on a copy stream,
verified checkpoints, rollback, preemption and restarts).

    PYTHONPATH=src python -m repro_torch.launch.train --steps 50 \\
        [--balance cost --accum 2] [--ckpt DIR --async-ckpt] [--device cpu]
        [--devices N]

``--devices N`` trains data-parallel over N ranks, one process each
(``torch.multiprocessing``, rendezvous through a file in a temporary
directory): rank r on ``cuda:r`` over NCCL, or with ``--device cpu`` on
the CPU over gloo.  Capacities are sized per device (``ceil(batch /
N)``), the balanced path goes through ``runtime.elastic_train`` (a
device drop re-bin-packs over the survivors and the dropped rank
leaves), rank 0 of the job prints and position 0 of the mesh writes the
checkpoints.  More ranks than visible GPUs raise.

``--arch <LM id>`` trains that architecture's ``SMOKE`` config from the
seed (``train_lm``, the JAX launcher's LM mode) on ``--device``, for any
of the ten ids: each family gets its own inputs (whisper float frames,
qwen2-vl (B, S, 3) positions, none for rwkv and whisper; the hybrid at
``ssd_chunk=8``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-moe-16b --steps 4 [--device cpu]
"""
from __future__ import annotations

import argparse
import itertools
import tempfile


def train_lm(args) -> int:
    """The JAX launcher's LM mode: the ``SMOKE`` config of ``--arch``,
    parameters from seed 0, Adam at 1e-3, batches of 4 x 32 from numpy's
    ``default_rng(0)`` as the JAX launcher draws them (tokens, or whisper's
    N(0, 1) frames, then labels; positions 0..31, on all three M-RoPE
    components); prints the loss about every tenth step and returns the
    steps taken."""
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.core.chgnet import resolve_device
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.models.api import family_fns
    from repro_torch.optim.adam import adam_init
    from repro_torch.optim.tree import leaves

    cfg = get_smoke(args.arch)
    fns = family_fns(cfg)
    # "cuda" is the card, and without CUDA an error
    device = resolve_device(None if args.device == "cuda" else args.device)
    params = fns.init(cfg, 0, device=device)
    opt = adam_init(params)
    kw = dict(ssd_chunk=8) if cfg.family == "hybrid" else {}
    step = make_lm_train_step(cfg, lr=1e-3, grad_clip=math.inf, **kw)
    rng = np.random.default_rng(0)
    b, s = 4, 32
    pos = torch.arange(s, device=device).expand(b, s)
    if fns.positions_3d:
        pos = pos[..., None].expand(b, s, 3)
    print(f"arch={cfg.name} (SMOKE) family={cfg.family} device={device} "
          f"parameters={sum(p.numel() for p in leaves(params))}", flush=True)
    for i in range(args.steps):
        if fns.token_input:
            x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
        else:
            x = torch.from_numpy(
                rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
        batch = [x.to(device), labels.to(device)]
        if fns.has_positions:
            batch.append(pos)
        params, opt, loss = step(params, opt, *batch)
        if i % max(1, args.steps // 10) == 0:
            print(f"  step {i:3d} loss {float(loss):.4f}", flush=True)
    return args.steps


def train_chgnet(args, mesh=None) -> int:
    """Train until ``--steps``, on one device or as one rank of ``mesh``;
    returns the step reached (the preempted step after a SIGTERM)."""
    from repro_torch.batching import capacity_for, ladder_for
    from repro_torch.configs import chgnet_mptrj as C
    from repro_torch.data import (
        BalancedBatchIterator, BatchIterator, Prefetcher, SyntheticConfig,
        make_dataset,
    )
    from repro_torch.runtime import (
        ChaosMonkey, ChaosSchedule, GracefulShutdown, PreemptionError,
        clear_resume_marker, elastic_train, latest_valid_step,
        read_resume_marker, run_with_restarts,
    )
    from repro_torch.train import TrainConfig, Trainer

    n_dev = 1 if mesh is None else mesh.size
    # rank 0 speaks for the mesh
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    ds = make_dataset(SyntheticConfig(num_crystals=args.crystals, seed=0))
    # one worst-case capacity or a bucket ladder, sized per device: a shard
    # holds up to ceil(batch / devices) samples
    per_dev = -(-args.batch // n_dev)
    caps = (capacity_for(ds, per_dev) if args.buckets <= 1
            else ladder_for(ds, per_dev, num_buckets=args.buckets))
    model_cfg = C.FAST_FS_HEAD if args.readout == "direct" else C.FAST_WO_HEAD
    model_cfg = model_cfg.with_(conv_impl=args.conv_impl,
                                precision=args.precision,
                                bond_store=args.bond_store,
                                bond_features=args.bond_features,
                                stress_mode=args.stress_mode,
                                table_residency=args.table_residency)
    train_cfg = TrainConfig(global_batch=args.batch, total_steps=args.steps,
                            loss=C.LOSS, grad_reduce=args.grad_reduce,
                            cost_refit_every=args.cost_refit_every,
                            rollback_on_divergence=args.rollback_on_divergence)
    device = args.device if mesh is None else str(mesh.device)
    say(f"device={device} devices={n_dev} init_lr={train_cfg.init_lr:.2e} "
          f"readout={args.readout} conv_impl={args.conv_impl} "
          f"precision={args.precision} bond_store={args.bond_store} "
          f"bond_features={args.bond_features} "
          f"stress_mode={args.stress_mode} async_ckpt={args.async_ckpt}",
          flush=True)
    if args.ckpt and (mesh is None or mesh.rank == 0):
        marker = read_resume_marker(args.ckpt)
        if marker:
            say(f"resuming after preemption at step {marker['step']} "
                f"({marker.get('reason', '?')})", flush=True)
            clear_resume_marker(args.ckpt)
    # one monkey for the whole run: each scheduled fault fires once
    monkey = None
    if args.chaos:
        monkey = ChaosMonkey(
            ChaosSchedule.parse(args.chaos, seed=args.chaos_seed),
            ckpt_dir=args.ckpt)
    shutdown = GracefulShutdown().install()
    # pinned copies on a stream of their own to the card; CPU batches as
    # they are packed
    copy_to = device if device.startswith("cuda") else None

    def batches(tr, it):
        """The rest of the run's steps of ``it`` through the Prefetcher."""
        tr.on_quarantine = it.add_quarantine
        stream = itertools.islice(itertools.cycle(iter(it)),
                                  max(args.steps - tr.step, 0))
        if monkey is not None:
            # inside the Prefetcher, so that transient faults take the
            # worker's retry and quarantine path (DESIGN.md §8)
            stream = monkey.wrap_batches(stream, start_step=tr.step)
        return Prefetcher(stream, device=copy_to)

    def one_pass(tr):
        if args.balance == "cost" or args.accum > 1:
            # cost-model bin packing + accumulation (DESIGN.md §6); the
            # Trainer's refit cost models and quarantines reach the
            # iterator through its hooks, and a device drop re-bin-packs
            # the plans over the survivors
            def batches_fn(num_devices):
                it = BalancedBatchIterator(
                    ds, args.batch, num_devices, caps,
                    num_micro=max(args.accum, 1),
                    shard=None if tr.mesh is None else tr.mesh.rank)
                tr.on_cost_model = it.update_cost_model
                return batches(tr, it)

            return elastic_train(tr, batches_fn, max_steps=args.steps,
                                 fault_injector=monkey)
        it = BatchIterator(ds, args.batch, n_dev, caps, load_balance=True,
                           tag_indices=args.rollback_on_divergence,
                           shard=None if tr.mesh is None else tr.mesh.rank)
        return tr.train(batches(tr, it), fault_injector=monkey)

    def loop(start):
        tr = Trainer(model_cfg, train_cfg,
                     device=args.device if mesh is None else None, mesh=mesh,
                     ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
                     async_ckpt=args.async_ckpt, shutdown=shutdown)
        try:
            if tr.maybe_restore():
                say(f"restored step {tr.step} from {args.ckpt}", flush=True)
            hist = []
            while True:
                before = tr.step
                hist = one_pass(tr)
                if mesh is not None and tr.mesh is None:
                    return tr.step  # this rank's device was dropped
                # a rollback consumes batches while moving the step back,
                # so an exhausted stream can leave the run short of
                # --steps: go on while each pass makes progress
                if tr.step >= args.steps or tr.step <= before:
                    break
            tr.save(wait=True)
        finally:
            tr.close()
        if hist:
            say(f"steps {tr.step - len(hist)}..{tr.step}: "
                f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; "
                f"stragglers={tr.straggler.flags} "
                f"rollbacks={tr.rollbacks}", flush=True)
        return tr.step

    try:
        # resume from the newest VALID checkpoint: a corrupt newest file is
        # skipped by the restore, so the resume step skips it too
        return run_with_restarts(
            loop, resume_step_fn=lambda: (latest_valid_step(args.ckpt) or 0)
            if args.ckpt else 0,
            max_restarts=3)
    except PreemptionError as exc:
        say(f"preempted at step {exc.step}; checkpoint + resume marker "
            f"written to {args.ckpt}", flush=True)
        return exc.step
    finally:
        shutdown.uninstall()


def _rank_main(rank: int, args, init_method: str, results) -> None:
    """One rank of ``--devices N``: join the mesh, train, report the step
    it reached."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import init_data_mesh

    device = "cpu" if args.device == "cpu" else f"cuda:{rank}"
    if device == "cpu":
        # the ranks share the host's cores: oversubscribed intra-op pools
        # spin against each other
        torch.set_num_threads(max(1, torch.get_num_threads() // args.devices))
    mesh = init_data_mesh(device, rank=rank, world_size=args.devices,
                          init_method=init_method)
    try:
        results.put(train_chgnet(args, mesh))
    finally:
        dist.destroy_process_group()


def train_data_parallel(args) -> int:
    """Spawn ``args.devices`` ranks of ``train_chgnet``; returns the step
    the run reached (the furthest rank's: a dropped rank stops early).
    Raises before spawning when the ranks outnumber the visible GPUs."""
    import torch
    import torch.multiprocessing as mp

    if args.device not in ("cuda", "cpu"):
        raise ValueError(f"--devices {args.devices} takes --device cuda "
                         f"(rank r on cuda:r) or cpu, not {args.device!r}")
    if args.device == "cuda" and args.devices > torch.cuda.device_count():
        raise ValueError(f"--devices {args.devices} needs as many GPUs; "
                         f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory() as tmp:
        results = mp.get_context("spawn").SimpleQueue()
        mp.start_processes(_rank_main, args=(args, f"file://{tmp}/store",
                                             results),
                           nprocs=args.devices, start_method="spawn")
        return max(results.get() for _ in range(args.devices))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="chgnet")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--crystals", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    ap.add_argument("--devices", type=int, default=1,
                    help="data-parallel ranks, one process each (rank r "
                         "on cuda:r, or on the CPU with --device cpu)")
    ap.add_argument("--readout", default="direct",
                    choices=["direct", "autodiff"])
    ap.add_argument("--conv-impl", default="unfused",
                    choices=["unfused", "fused"],
                    help="fused = the message-passing CUDA kernels "
                         "(DESIGN.md §3)")
    ap.add_argument("--precision", default="f32",
                    choices=["f32", "bf16", "mixed"],
                    help="end-to-end precision policy (DESIGN.md §4)")
    ap.add_argument("--bond-store", default="directed",
                    choices=["directed", "undirected"],
                    help="undirected = half-graph bond store (DESIGN.md §5)")
    ap.add_argument("--bond-features", default="directed",
                    choices=["directed", "undirected"],
                    help="undirected = symmetric half-graph trunk "
                         "(DESIGN.md §10; requires --bond-store undirected)")
    ap.add_argument("--stress-mode", default="mlp",
                    choices=["mlp", "bond_virial"],
                    help="direct-readout stress tier (DESIGN.md §7)")
    ap.add_argument("--table-residency", default="auto",
                    choices=["auto", "vmem", "hbm"],
                    help="accepted so that configs carry over; the card "
                         "keeps every table in device memory")
    ap.add_argument("--grad-reduce", default="bucketed",
                    choices=["plain", "bucketed", "compressed"])
    ap.add_argument("--cost-refit-every", type=int, default=0,
                    help="refit the LPT cost model from measured "
                         "microbatch times every K steps (0 = off; with "
                         "--balance cost / --accum)")
    ap.add_argument("--balance", default="pair", choices=["pair", "cost"],
                    help="pair = paper Fig. 4 smallest+largest pairing; "
                         "cost = LPT bin packing over the cost model "
                         "(DESIGN.md §6)")
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatches per optimizer step, each in its "
                         "own capacity bucket (DESIGN.md §6); >1 implies "
                         "the balanced StepPlan path")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--async-ckpt", action="store_true",
                    help="write checkpoints from a background thread "
                         "(DESIGN.md §8)")
    ap.add_argument("--rollback-on-divergence", action="store_true",
                    help="NaN/loss-spike streaks restore the newest valid "
                         "checkpoint, halve the LR and quarantine the "
                         "streak's batches (DESIGN.md §8)")
    ap.add_argument("--chaos", default=None,
                    help="fault-injection schedule, e.g. "
                         "'nan@5,sigterm@12,ckpt_bitflip@20' (runtime."
                         "chaos; kinds: crash drop sigterm straggler "
                         "ckpt_truncate ckpt_bitflip nan transient "
                         "prefetch_crash)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--buckets", type=int, default=2,
                    help="capacity buckets (1 = single worst-case pad)")
    args = ap.parse_args(argv)
    if args.arch != "chgnet":
        if args.devices != 1:
            raise ValueError("LM training runs on one device")
        return train_lm(args)
    if args.devices < 1:
        raise ValueError(f"--devices must be >= 1, got {args.devices}")
    return train_chgnet(args) if args.devices == 1 \
        else train_data_parallel(args)


if __name__ == "__main__":
    main()
