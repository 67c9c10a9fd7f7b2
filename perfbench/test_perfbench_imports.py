"""What the harness loads and reads: no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` (compared
whole: ``repro_torch`` is the port), and no file under ``benchmarks/``
(the JAX package's harness).  Checked in a fresh interpreter that
imports every file of the harness, the drivers among them, and drives a
whole run on the CPU.  The harness by itself loads nothing of the port
and nothing of the reference: those are the drivers'."""
import ast
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
from perfbench import harness
alone = sorted(m for m in sys.modules if m.split(".")[0] == "repro_torch"
               or m.startswith("perfbench.reference"))
from perfbench import calibrate, devtrace, roofline  # noqa
from perfbench import run  # noqa
for sub in ("metrics", "kernels"):
    for f in sorted((harness.BENCH / sub).glob("*.py")):
        harness.load_file(f)
for f in sorted((harness.BENCH / "drivers").glob("*.py")):
    if f.stem != "__init__":
        harness.module_at(harness.BENCH, f"drivers/{f.name}")
spec = harness.cell_spec(sys.argv[1])
spec["mix"] = dict(spec["mix"], pool=8, batch=2, trace_seconds=0.1,
                   sizes=dict(spec["mix"]["sizes"], lognormal_mu=1.2,
                              min_atoms=2, max_atoms=6))
harness.run(spec, 7, 0.2, True, device="cpu")
print(json.dumps({"modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "opened": opened, "harness_alone": alone}))
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
    assert got["harness_alone"] == []


def _imported(path) -> set:
    """Top-level names of every module that the file imports, at any
    depth of its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_harness_imports_nothing_of_the_program_or_reference():
    for name in _imported(harness.BENCH / "harness.py"):
        assert name.split(".")[0] != "repro_torch", name
        assert not name.startswith("perfbench.reference"), name


def test_drivers_import_no_jax():
    drivers = sorted((harness.BENCH / "drivers").glob("*.py"))
    assert len(drivers) > 1
    for path in drivers:
        for name in _imported(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert "repro" not in text.replace("reproduc", ""), path
