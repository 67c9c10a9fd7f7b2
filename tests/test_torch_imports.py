"""Import hygiene of the PyTorch port: nothing under src/repro_torch, and
nothing in chip_smoke.py, imports JAX or the JAX package ``repro``, and
the port's serving and training paths, its runtime and its launcher
import in an interpreter where JAX cannot be imported at all; its
checkpoints need neither ``msgpack`` nor ``ml_dtypes``."""
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
            "src/repro_torch/serve/lm.py",
            "src/repro_torch/batching/cost.py",
            "src/repro_torch/batching/balance.py",
            "src/repro_torch/runtime/_msgpack.py",
            "src/repro_torch/runtime/checkpoint.py",
            "src/repro_torch/runtime/async_ckpt.py",
            "src/repro_torch/runtime/fault.py",
            "src/repro_torch/runtime/chaos.py",
            "src/repro_torch/runtime/elastic.py",
            "src/repro_torch/distributed/mesh.py",
            "src/repro_torch/distributed/collectives.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/launch/steps.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/configs/qwen15_110b.py",
            "src/repro_torch/configs/phi35_moe.py",
            "src/repro_torch/configs/deepseek_moe_16b.py",
            "src/repro_torch/models/ssm.py",
            "src/repro_torch/models/hybrid.py",
            "src/repro_torch/models/rwkv.py",
            "src/repro_torch/models/encdec.py",
            "src/repro_torch/configs/qwen2_vl_2b.py",
            "src/repro_torch/configs/zamba2_1p2b.py",
            "src/repro_torch/configs/rwkv6_3b.py",
            "src/repro_torch/configs/whisper_medium.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/distributed/pipeline.py",
            "src/repro_torch/configs/shapes.py",
            "src/repro_torch/analysis/roofline.py",
            "src/repro_torch/launch/dryrun.py"} <= names


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
    editing csrc/hopper.cuh rebuilds swiglu, flash_attention, gated_mlp and
    the three message-passing libraries (f32, bf16, the convs' backward),
    and no other library; editing csrc/message_passing.cuh rebuilds those
    three alone."""
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
    assert changed == {"swiglu", "flash_attention", "gated_mlp",
                       "message_passing", "message_passing_bf16",
                       "message_passing_bwd"}
    # the message-passing templates rebuild each of their libraries
    assert [h.name for h in build._headers(csrc / "message_passing.cu")] \
        == ["message_passing.cuh", "hopper.cuh"]
    before = after
    templates = csrc / "message_passing.cuh"
    templates.write_text(templates.read_text() + "\n// edited\n")
    after = {name: build._out_path(name) for name in build.SIGNATURES}
    assert {n for n in build.SIGNATURES if before[n] != after[n]} == \
        {"message_passing", "message_passing_bf16", "message_passing_bwd"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_without_jax(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.serve, repro_torch.convert, repro_torch.data\n"
        "import repro_torch.train, repro_torch.optim\n"
        "import repro_torch.configs.chgnet_mptrj\n"
        "import repro_torch.models, repro_torch.serve.lm\n"
        "import repro_torch.configs.llama3_8b\n"
        "import repro_torch.configs.deepseek_moe_16b\n"
        "import repro_torch.models.moe, repro_torch.launch.steps\n"
        "import repro_torch.kernels.build\n"
        "import repro_torch.batching.balance, repro_torch.batching.cost\n"
        "import repro_torch.runtime, repro_torch.launch.train\n"
        "import repro_torch.distributed, repro_torch.runtime.elastic\n"
        "import repro_torch.models.ssm, repro_torch.models.hybrid\n"
        "import repro_torch.models.rwkv, repro_torch.models.encdec\n"
        "from repro_torch.configs import ARCH_IDS, get_config\n"
        "from repro_torch.models.api import family_fns\n"
        "for arch in ARCH_IDS:\n"
        "    family_fns(get_config(arch))\n"
        "import repro_torch.distributed.pipeline, repro_torch.launch.mesh\n"
        "import repro_torch.configs.shapes, repro_torch.analysis.roofline\n"
        "from repro_torch.launch import dryrun\n"
        f"assert dryrun.main(['--arch', 'llama3-8b', '--shape', 'decode_32k',\n"
        f"                    '--out', {str(tmp_path / 'dry.json')!r}]) == 0\n"
        "from repro_torch.launch import train\n"
        "assert train.main(['--arch', 'zamba2-1.2b', '--steps', '1',\n"
        "                   '--device', 'cpu']) == 1\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_checkpoints_need_neither_msgpack_nor_ml_dtypes(tmp_path):
    """The port's checkpoint round trip (a bf16 leaf included) in an
    interpreter where neither package can be imported, as on the card's
    machine."""
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.runtime import restore_checkpoint, "
        "save_checkpoint\n"
        "tree = {'w': torch.arange(5, dtype=torch.bfloat16), "
        "'n': [torch.tensor(3)]}\n"
        f"save_checkpoint({str(tmp_path)!r}, 1, tree)\n"
        f"got, step, _ = restore_checkpoint({str(tmp_path)!r}, tree)\n"
        "assert step == 1 and torch.equal(got['w'], tree['w'])\n"
        "assert torch.equal(got['n'][0], tree['n'][0])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
