"""Import hygiene of the PyTorch port: nothing under src/repro_torch, and
nothing in chip_smoke.py, imports JAX or the JAX package ``repro``, and
the port's serving and training paths import in an interpreter where JAX
cannot be imported at all."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"src/repro_torch/serve/engine.py", "src/repro_torch/convert.py",
            "src/repro_torch/kernels/ops.py", "chip_smoke.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/serve/lm.py"} <= names


def test_every_library_has_its_source():
    """Each library that kernels/build.py loads is a source under csrc/ that
    defines every C entry point it binds (the CUDA build runs only on the
    card; this holds the table to the sources here)."""
    from repro_torch.kernels import build

    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == \
        sorted(build.SIGNATURES)
    for lib, entries in build.SIGNATURES.items():
        text = (build.CSRC / f"{lib}.cu").read_text()
        for fn in entries:
            assert f"int {fn}(" in text, (lib, fn)


def test_digest_follows_included_headers(tmp_path, monkeypatch):
    """A library's build key hashes the .cuh headers its source includes:
    editing csrc/hopper.cuh rebuilds swiglu, flash_attention and gated_mlp,
    and no other library."""
    import shutil

    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build._out_path(name) for name in build.SIGNATURES}
    assert [h.name for h in build._headers(csrc / "swiglu.cu")] == \
        ["hopper.cuh"]
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build._out_path(name) for name in build.SIGNATURES}
    changed = {n for n in build.SIGNATURES if before[n] != after[n]}
    assert changed == {"swiglu", "flash_attention", "gated_mlp"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.serve, repro_torch.convert, repro_torch.data\n"
        "import repro_torch.train, repro_torch.optim\n"
        "import repro_torch.configs.chgnet_mptrj\n"
        "import repro_torch.models, repro_torch.serve.lm\n"
        "import repro_torch.configs.llama3_8b\n"
        "import repro_torch.kernels.build\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
