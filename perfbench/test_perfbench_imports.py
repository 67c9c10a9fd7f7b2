"""What the harness loads and reads: no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` (compared
whole: ``repro_torch`` is the port), and no file under ``benchmarks/``
(the JAX package's harness).  Checked in a fresh interpreter that
imports every file of the harness and drives a whole run on the CPU."""
import json
import os
import subprocess
import sys

from perfbench import harness

PROBE = r"""
import json, sys
opened = []

def hook(event, args):
    if event == "open" and args and isinstance(args[0], (str, bytes)):
        path = os.fsdecode(args[0])
        if "/benchmarks/" in path or path.startswith("benchmarks"):
            opened.append(path)

import os
sys.addaudithook(hook)
from perfbench import calibrate, devtrace, harness, roofline  # noqa
from perfbench import run  # noqa
for sub in ("metrics", "kernels"):
    for f in sorted((harness.BENCH / sub).glob("*.py")):
        harness.load_file(f)
spec = harness.cell_spec(sys.argv[1])
spec["mix"] = dict(spec["mix"], pool=8, batch=2, trace_seconds=0.1,
                   sizes=dict(spec["mix"]["sizes"], lognormal_mu=1.2,
                              min_atoms=2, max_atoms=6))
harness.run(spec, 7, 0.2, True, device="cpu")
print(json.dumps({"modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "opened": opened}))
"""


def test_harness_loads_no_jax_and_reads_no_benchmarks():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(harness.ROOT), str(harness.ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", PROBE,
                          "fastchgnet_wo_head.mptrj_b128"], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert not set(got["modules"]) & set(harness.FORBIDDEN)
    assert "repro_torch" in got["modules"]
    assert got["opened"] == []


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert "repro" not in text.replace("reproduc", ""), path
