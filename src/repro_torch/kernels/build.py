"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes``; all sources compile in
parallel.  Libraries go to ``build/kernels/<hash>/`` at the root of the
checkout, keyed by a hash of the source text and the compiler flags, so
an edited source is rebuilt and an unchanged one is loaded as is.
Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of every C entry point, by library
SIGNATURES = {
    "message_passing": {
        "atom_conv_fwd": [_P] * 12 + [_I, _I, _I, _I, _P],
        "bond_conv_fwd": [_P] * 15 + [_I, _I, _I, _P],
        "sym_msg_fwd": [_P] * 13 + [_I, _I, _I, _I, _P],
        "force_readout_fwd": [_P] * 8 + [_I, _I, _I, _P],
        "force_virial_fwd": [_P] * 10 + [_I, _I, _I, _P],
        "virial_crystal_sum": [_P] * 4 + [_I, _I, _P],
    },
    "segment_sum": {
        "segment_sum_fwd": [_P] * 3 + [_I, _I, _I, _P],
        "sym_accum_fwd": [_P] * 4 + [_I, _I, _I, _P],
    },
    "gated_mlp": {
        "gated_mlp_fwd": [_P] * 6 + [_I, _I, _I, _P],
    },
    "basis": {
        "rbf_fwd": [_P] * 3 + [_I, _I, _F, _F, _I, _P],
        "fourier_fwd": [_P] * 2 + [_I, _I, _P],
    },
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def _digest(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
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
            tmp, out)
    for name, (proc, tmp, out) in pending.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
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


def entry(library: str, fn: str):
    """The ctypes function ``fn`` of ``library``, building it if needed."""
    return getattr(load_libraries()[library], fn)
