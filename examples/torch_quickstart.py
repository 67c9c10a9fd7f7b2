"""Quickstart of the PyTorch port: build a synthetic crystal batch, run
FastCHGNet, train a few steps (cost-balanced microbatches), checkpoint
and restore, serve one batch.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The device defaults to the card (``cuda``), where the fused tier runs its
CUDA kernels; on the CPU the same code runs their plain versions.
"""
import argparse
import itertools
import tempfile

from repro_torch.batching import capacity_for, ladder_for
from repro_torch.configs import chgnet_mptrj as C
from repro_torch.core.chgnet import chgnet_apply, chgnet_init
from repro_torch.data import (
    BalancedBatchIterator, BatchIterator, SyntheticConfig, make_dataset,
)
from repro_torch.optim.tree import leaves
from repro_torch.train import TrainConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # 1. data: synthetic MPtrj-like crystals with analytic E/F/sigma/magmom
    ds = make_dataset(SyntheticConfig(num_crystals=64, max_atoms=24, seed=0))
    caps = capacity_for(ds, per_device_batch=8)
    print(f"dataset: {len(ds)} crystals, per-batch caps {caps}")

    # 2. model: FastCHGNet with the fused message-passing kernels
    cfg = C.FAST_FUSED
    params = chgnet_init(0, cfg)
    print(f"FastCHGNet params: {sum(p.numel() for p in leaves(params)):,} "
          "(paper: 429.1K)")

    # 3. one forward pass
    batch = next(iter(BatchIterator(ds, 8, 1, caps)))
    out = chgnet_apply(params, cfg, batch)
    print("forward:", {k: tuple(v.shape) for k, v in out.items()})

    # 4. a few training steps: each step two cost-balanced microbatches,
    # each in its own bucket of the ladder, gradients summed, one Adam step
    with tempfile.TemporaryDirectory() as ckpt:
        tcfg = TrainConfig(global_batch=8, total_steps=100, loss=C.LOSS)
        tr = Trainer(cfg, tcfg, device=args.device, ckpt_dir=ckpt,
                     ckpt_every=5)
        plans = BalancedBatchIterator(ds, 8, 1, ladder_for(ds, 4),
                                      num_micro=2)
        hist = tr.train(itertools.islice(itertools.cycle(iter(plans)), 10))
        print(f"train: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
              f"over {len(hist)} steps")

        # 5. a verified checkpoint, restored into a fresh Trainer
        tr2 = Trainer(cfg, tcfg, seed=1, device=args.device, ckpt_dir=ckpt)
        print(f"restored: {tr2.maybe_restore()} at step {tr2.step}")

    # 6. an MD-style serve step
    pred = tr2.serve(batch)
    print(f"serve: energy[0] = {float(pred['energy'][0]):.3f} eV")


if __name__ == "__main__":
    main()
