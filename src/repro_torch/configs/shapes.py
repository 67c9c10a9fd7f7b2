"""Assigned input shapes x ``input_specs()`` builders for the dry run:
PyTorch port of ``repro.configs.shapes``.

Shapes (assigned to every LM arch):
    train_4k     seq=4096   global_batch=256   (training step)
    prefill_32k  seq=32768  global_batch=32    (inference prefill)
    decode_32k   seq=32768  global_batch=128   (one-token decode, full KV)
    long_500k    seq=524288 global_batch=1     (long-context decode;
                 SSM/hybrid only: skipped for pure full-attention archs)

``input_specs(cfg, shape, multi_pod=..., mesh_sizes=...)`` returns, for
every model input of the cell's step, a tensor on the ``meta`` device
(shape and dtype, no storage: nothing is allocated even at qwen1.5-110b
or long_500k) and its spec tuple under JAX's mesh layout (one entry a
dimension: an axis name, a tuple of names or ``None``).  The port runs
no sharded step; the specs let the dry run state each input's bytes a
rank (``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.api import family_fns
from repro_torch.models.config import LMConfig
from repro_torch.models.layers import pspec


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str       # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def _bax(batch: int, multi_pod: bool, mesh_sizes: dict):
    """Batch sharding axes, degraded to replication if not divisible."""
    axes = batch_axes(multi_pod)
    total = 1
    for a in axes:
        total *= mesh_sizes.get(a, 1)
    return axes if batch % total == 0 and total > 1 else None


def cell_status(cfg: LMConfig, shape: Shape) -> str:
    """'ok' or 'skip:<reason>' for this (arch x shape) cell."""
    fns = family_fns(cfg)
    if shape.name == "long_500k" and not fns.supports_long_context:
        return ("skip: pure full-attention arch — 524k dense-attention "
                "decode is defined for sub-quadratic (SSM/hybrid) archs only")
    return "ok"


def meta(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on ``meta``: no storage."""
    return torch.empty(shape, dtype=dtype, device="meta")


def to_meta(tree):
    """``tree`` with every tensor leaf as a ``meta`` tensor of its shape
    and dtype, and every Python int (a state's fill count) as a 0-d
    int32 one, as JAX's ``pos`` leaf."""
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_meta(v) for v in tree]
    if isinstance(tree, int):
        return meta((), torch.int32)
    return meta(tree.shape, tree.dtype)


def input_specs(cfg: LMConfig, shape: Shape, *, multi_pod: bool,
                mesh_sizes: dict):
    """Returns dict(kind, args=tuple of meta-tensor trees, specs=tuple of
    spec-tuple trees, donate=tuple of argument indices)."""
    fns = family_fns(cfg)
    b, sl = shape.batch, shape.seq
    bax = _bax(b, multi_pod, mesh_sizes)
    tok_spec = pspec(bax, None)
    cdtype = getattr(torch, cfg.compute_dtype)

    def positions(batch, seq):
        if not fns.has_positions:
            return None, None
        if fns.positions_3d:
            return meta((batch, seq, 3), torch.int32), pspec(bax, None, None)
        return meta((batch, seq), torch.int32), tok_spec

    def model_input():
        if fns.token_input:
            return meta((b, sl), torch.int32), tok_spec
        # whisper: precomputed frame embeddings (frontend stub)
        return meta((b, sl, cfg.d_model), cdtype), pspec(bax, None, None)

    if shape.kind in ("train", "prefill"):
        x, x_spec = model_input()
        args, specs = (x,), (x_spec,)
        if shape.kind == "train":
            args, specs = args + (meta((b, sl), torch.int32),), \
                specs + (tok_spec,)
        pos, pos_spec = positions(b, sl)
        if pos is not None:
            args, specs = args + (pos,), specs + (pos_spec,)
        return {"kind": shape.kind, "args": args, "specs": specs,
                "donate": ()}

    # decode: one new token against a seq-len KV cache / recurrent state
    pos, pos_spec = positions(b, 1)
    state_struct, state_spec = decode_state_structs(
        cfg, b, sl, multi_pod=multi_pod, mesh_sizes=mesh_sizes)
    args = (meta((b, 1), torch.int32), state_struct) + (
        (pos,) if pos is not None else ())
    specs = (pspec(bax, None), state_spec) + (
        (pos_spec,) if pos is not None else ())
    return {"kind": "decode", "args": args, "specs": specs, "donate": (2,)}


def decode_state_structs(cfg: LMConfig, batch: int, max_len: int, *,
                         multi_pod: bool, mesh_sizes: dict):
    """(meta-tensor tree, spec-tuple tree) of the decode state, bf16
    caches as in JAX."""
    fns = family_fns(cfg)
    bax = _bax(batch, multi_pod, mesh_sizes)
    seq_axis = "model"  # SP fallback axis for KV when heads can't shard
    spec = fns.decode_state_specs(cfg, mesh_sizes, bax, seq_axis)
    if cfg.family == "encdec":
        kv = meta((cfg.num_decoder_layers, batch, max_len,
                   cfg.num_kv_heads, cfg.resolved_head_dim), torch.bfloat16)
        struct = {"k": kv, "v": kv, "xk": kv, "xv": kv,
                  "pos": meta((), torch.int32)}
        return struct, spec
    struct = fns.init_decode_state(cfg, batch, max_len, torch.bfloat16,
                                   "meta")
    return to_meta(struct), spec
