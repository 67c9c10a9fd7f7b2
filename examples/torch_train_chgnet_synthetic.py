"""End-to-end training script of the PyTorch port: FastCHGNet (~434K params)
on the synthetic MPtrj-like dataset with the full host side: the
load-balance sampler (or cost-balanced microbatches), prefetch on a copy
stream, verified checkpoints and a restart after an injected fault.

    PYTHONPATH=src python examples/torch_train_chgnet_synthetic.py \\
        [--steps 300] [--batch 32] [--accum 2] [--ckpt /tmp/chgnet_ckpt] \\
        [--inject-fault] [--device cpu]

``python -m repro_torch.launch.train`` is the launcher with every option
(rollback, chaos schedules, async checkpoints, preemption).
"""
import argparse
import itertools

from repro_torch.batching import capacity_for, ladder_for
from repro_torch.configs import chgnet_mptrj as C
from repro_torch.data import (
    BalancedBatchIterator, BatchIterator, Prefetcher, SyntheticConfig,
    make_dataset,
)
from repro_torch.runtime import FaultInjector, latest_step, run_with_restarts
from repro_torch.train import TrainConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--crystals", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--conv-impl", default="fused",
                    choices=["unfused", "fused"])
    ap.add_argument("--precision", default="f32",
                    choices=["f32", "bf16", "mixed"],
                    help="end-to-end precision policy (DESIGN.md §4)")
    ap.add_argument("--accum", type=int, default=1,
                    help="cost-balanced microbatches per step (DESIGN.md "
                         "§6), each in its own capacity bucket")
    ap.add_argument("--ckpt", default="/tmp/chgnet_ckpt")
    ap.add_argument("--inject-fault", action="store_true")
    args = ap.parse_args()

    ds = make_dataset(SyntheticConfig(num_crystals=args.crystals, seed=0))
    model_cfg = C.FAST_FS_HEAD.with_(conv_impl=args.conv_impl,
                                     precision=args.precision)
    train_cfg = TrainConfig(global_batch=args.batch,
                            total_steps=args.steps, loss=C.LOSS)
    print(f"init LR (Eq. 14): {train_cfg.init_lr:.2e}")
    injector = FaultInjector({args.steps // 3}) if args.inject_fault else None
    copy_to = args.device if args.device.startswith("cuda") else None

    def loop(start_step):
        tr = Trainer(model_cfg, train_cfg, device=args.device,
                     ckpt_dir=args.ckpt, ckpt_every=50)
        tr.maybe_restore()
        if args.accum > 1:
            it = BalancedBatchIterator(
                ds, args.batch, 1, ladder_for(ds, args.batch // args.accum),
                num_micro=args.accum)
        else:
            it = BatchIterator(ds, args.batch, 1, capacity_for(ds, args.batch))
        batches = Prefetcher(itertools.islice(itertools.cycle(iter(it)),
                                              args.steps - tr.step),
                             device=copy_to)
        hist = tr.train(batches, fault_injector=injector)
        tr.save()
        for i in range(0, len(hist), max(1, len(hist) // 10)):
            h = hist[i]
            print(f"  step {tr.step - len(hist) + i:4d} "
                  f"loss={h['loss']:.4f} maeE={h['mae_e_per_atom']*1e3:.1f}meV"
                  f" maeF={h['mae_f']*1e3:.0f}meV/A")
        return tr

    tr = run_with_restarts(
        loop, resume_step_fn=lambda: latest_step(args.ckpt) or 0,
        max_restarts=3)
    print(f"done at step {tr.step}; straggler flags: {tr.straggler.flags}")


if __name__ == "__main__":
    main()
