"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes``; all sources compile in
parallel.  Libraries go to ``build/kernels/<hash>/`` at the root of the
checkout, keyed by a hash of the source text, of every ``csrc/*.cuh``
header it includes (``hopper.cuh``: the TMA / mbarrier / wgmma /
mma.sync helpers; ``message_passing.cuh``: the message-passing templates
that ``message_passing.cu`` instantiates in f32 and
``message_passing_bf16.cu`` in bf16) and of the compiler flags, so an edited source or
header is rebuilt and an unchanged one is loaded as is.  Beside each
library, ``lib<name>.log`` keeps the compiler's output (``-Xptxas -v``:
registers, shared memory and spills of every kernel) and its build time.
TMA descriptors are encoded through ``cudaGetDriverEntryPoint``, so no
library links against ``libcuda``.  Nothing here runs at import time: the
CPU tests import every module, and this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of every C entry point, by library
SIGNATURES = {
    "message_passing": {
        "atom_conv_fwd": [_P] * 12 + [_I] * 7 + [_P],
        "bond_conv_fwd": [_P] * 15 + [_I] * 6 + [_P],
        "sym_msg_fwd": [_P] * 13 + [_I] * 6 + [_P],
        "force_readout_fwd": [_P] * 8 + [_I] * 6 + [_P],
        "force_virial_fwd": [_P] * 10 + [_I] * 6 + [_P],
        "virial_crystal_sum": [_P] * 4 + [_I, _I, _P],
    },
    # the same templates at bf16 operands, compiled beside the f32 ones
    "message_passing_bf16": {
        "atom_conv_bf16_fwd": [_P] * 12 + [_I] * 7 + [_P],
        "bond_conv_bf16_fwd": [_P] * 15 + [_I] * 6 + [_P],
        "force_readout_bf16_fwd": [_P] * 8 + [_I] * 6 + [_P],
    },
    "segment_sum": {
        "segment_sum_fwd": [_P] * 3 + [_I, _I, _I, _P],
        "sym_accum_fwd": [_P] * 4 + [_I, _I, _I, _P],
    },
    "gated_mlp": {
        "gated_mlp_fwd": [_P] * 6 + [_I, _I, _I, _P],
    },
    "basis": {
        "rbf_fwd": [_P] * 3 + [_I, _I, _F, _F, _I, _I, _I, _P],
        "fourier_fwd": [_P] * 2 + [_I, _I, _I, _I, _P],
    },
    "swiglu": {
        "swiglu_fwd": [_P] * 7 + [_I] * 9 + [_P],
    },
    "flash_attention": {
        "flash_attention_fwd": [_P] * 4 + [_I] * 4 + [_F, _I, _I, _P],
    },
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def _headers(src: Path) -> list[Path]:
    """The ``.cuh`` headers beside ``src`` that it includes, directly or
    through another header, in the order first reached."""
    found, todo = [], [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_text()):
            path = src.parent / name
            if path.exists() and path not in found:
                found.append(path)
                todo.append(path)
    return found


def _digest(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    for header in _headers(src):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _out_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    return BUILD_ROOT / _digest(src) / f"lib{name}.so"


@functools.cache
def load_libraries() -> dict[str, ctypes.CDLL]:
    """Compile what is missing (in parallel), load every library once.

    Returns ``{name: CDLL}`` with ``argtypes``/``restype`` set.  Raises
    ``RuntimeError`` with the compiler's output if a build fails.
    """
    pending = {}
    for name in SIGNATURES:
        out = _out_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        pending[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in pending.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        out.with_suffix(".log").write_text(
            f"nvcc {time.perf_counter() - t0:.2f} s (in parallel with the "
            f"other sources)\n{log}")
        os.replace(tmp, out)
    libs = {}
    for name, entries in SIGNATURES.items():
        lib = ctypes.CDLL(str(_out_path(name)))
        for fn, argtypes in entries.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        libs[name] = lib
    return libs


def build_log(name: str) -> str:
    """The compiler output kept beside library ``name`` (after a build)."""
    return _out_path(name).with_suffix(".log").read_text()


def entry(library: str, fn: str):
    """The ctypes function ``fn`` of ``library``, building it if needed."""
    return getattr(load_libraries()[library], fn)
