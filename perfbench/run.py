"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Looks the cell up in ``BENCHMARK.json``, runs it on the card and prints
the result as one JSON line, last on standard output, after the numbers
compared for ``correct`` on standard error.  ``harness`` keeps the run's
timeline and computes the end-to-end metrics; the driver that the cell's
configuration names (``drivers/``) sets up the program, feeds its timed
entry and runs the reference's check.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer ones.
Exits non-zero, printing no result, without as many cards as the cell
asks for, or if JAX or the JAX package was loaded.  The port builds its
CUDA kernels once into ``build/kernels/`` of the checkout (sm_90a code,
no PTX left for the driver to compile) and launches no Triton kernel, so
no other build or kernel cache is written.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# one process with few threads: one intra-op thread for the host's small
# tensor and array operations, so that idle pool threads do not contend
# with the step's dispatch and the prefetcher's packing
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(THREADS)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    import torch

    from perfbench import harness

    spec = harness.cell_spec(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START)
    # the window has closed: nothing this process loaded may be JAX's
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
