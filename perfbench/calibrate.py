"""The readings that the limits of ``correct`` are set from.

    python3 perfbench/calibrate.py --workload NAME --seeds 1,2,3 \
        [--variants program,control,half_batch] [--out FILE]

For each seed, in one process: set-up and the first three steps of the
cell through the window's feed, then the numbers compared against the
reference (``program``); the same numbers for the reference computed in
TF32 in the program's place (``control``); and for the program with half
of each batch left out, the loss taken over the rest (``half_batch``).
No measured window: the first steps are what is compared.  Prints one
JSON line per seed and variant (also appended to ``--out``).  The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def readings(spec: dict, seed: int, device: str, variants) -> list:
    """[(variant, numbers)] of one seed, in the order of ``variants``;
    ``program`` is followed by ``program_leaves`` (``_leaf_look``)."""
    from perfbench import harness

    prog = harness.Program(spec, seed, device)
    data = (prog.crystals, prog.ds)
    try:
        got = prog.first_steps()
    finally:
        prog.close()
    batches, idx, init = prog.first_batches, prog.first_indices, prog.init
    del prog
    ref, graphs = harness.reference_readings(spec, init, data[0], idx,
                                             device)
    out = []
    for variant in variants:
        if variant == "program":
            out.append((variant, harness.numbers(got, ref, batches, graphs)))
            out.append(("program_leaves", _leaf_look(got, ref, init)))
        elif variant == "control":
            ctl, _ = harness.reference_readings(spec, init, data[0], idx,
                                                device, tf32=True)
            out.append((variant, dict(
                graph=0, **harness.ref_train.compare(ctl, ref))))
        else:
            bad = harness.Program(spec, seed, device, variant, data=data)
            try:
                wrong = bad.first_steps()
            finally:
                bad.close()
            out.append((variant, harness.numbers(
                wrong, ref, bad.first_batches, graphs)))
    return out


def _paths(tree, at="") -> list:
    """Leaf names in ``reference.chgnet.leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{at}.{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{at}[{i}]")]
    return [at.lstrip(".")]


def _leaf_look(got: dict, ref: dict, init: dict) -> dict:
    """What the change's leaves read besides the numbers compared: the
    90th-percentile leaf, the worst leaf with every element counted, and
    the leaf that ``update_worst`` reads with how many of its elements
    count."""
    from perfbench.reference.train import element_keep, leaf_gaps

    gaps = leaf_gaps(got["delta"], ref["delta"])
    elems = element_keep(ref["grad"])
    count = [bool(m.any()) for m in elems]
    masked = leaf_gaps([d * m for d, m in zip(got["delta"], elems)],
                       [d * m for d, m in zip(ref["delta"], elems)], count)
    worst = [i for i, c in enumerate(count) if c][int(masked.argmax())]
    return {"update_p90": float(np.percentile(gaps, 90)),
            "update_worst_all": float(gaps.max()),
            "worst_leaf": _paths(init)[worst],
            "worst_leaf_kept": [int(elems[worst].sum()),
                                elems[worst].numel()]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program,control,half_batch")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    import torch

    from perfbench import harness

    spec = harness.cell_spec(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for variant, nums in readings(spec, seed, "cuda",
                                      args.variants.split(",")):
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "variant": variant, "numbers": nums,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
