"""The readings that the limits of ``correct`` are set from.

    python3 perfbench/calibrate.py --workload NAME --seeds 1,2,3 \
        [--variants program,control,half_batch] [--out FILE]

For each seed, in one process, the cell's driver (``readings``) sets up
and runs the first steps of the cell through the window's feed, then
gives the numbers compared against the reference (``program``); the same
numbers for the reference computed in TF32 in the program's place
(``control``); and for the program with half of each batch left out, the
loss taken over the rest (``half_batch``).  No measured window: the
first steps are what is compared.  Prints one
JSON line per seed and variant (also appended to ``--out``).  The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(spec: dict, seed: int, device: str, variants) -> list:
    """[(variant, numbers)] of one seed, in the order of ``variants``, as
    the cell's driver reads them (``readings``)."""
    from perfbench import harness

    return harness.driver(spec).readings(spec, seed, device, variants)


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
