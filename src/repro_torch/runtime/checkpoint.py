"""Fault-tolerant verified checkpointing, PyTorch port of
``repro.runtime.checkpoint`` (format 2; DESIGN.md §8).

The files are the JAX package's, byte for byte for the same tree, so
checkpoints move both ways between the packages:

  - **layout**: one MessagePack map ``{"format", "step", "meta",
    "manifest", "arrays"}``; ``arrays`` maps each leaf's key, the string
    ``jax.tree_util.keystr`` gives (``"['params']['blocks'][0]['w']"``),
    in JAX's flattening order (dict keys sorted, lists in order), to
    ``{"dtype", "shape", "data"}``: numpy's dtype string (``"<f4"``;
    ``"bfloat16"`` by name), the shape, the raw little-endian bytes;
  - **verified**: ``manifest`` holds every array's CRC32;
    ``verify_checkpoint`` and the restore detect truncation and bit flips
    instead of restoring garbage;
  - **atomic**: written to ``<name>.tmp``, fsynced, renamed with
    ``os.replace`` and the directory fsynced;
  - **fallback**: a restore with ``step=None`` walks newest -> oldest and
    restores the newest *valid* file;
  - **keep-K**: only checksummed-complete files count toward K.

The codec is the port's own (``runtime._msgpack``), bf16 leaves go
through ``torch.bfloat16`` and raw bytes, so neither ``msgpack`` nor
``ml_dtypes`` is needed.  Trees are nested dicts and lists of tensors
(the Trainer's state); a restored leaf takes its template leaf's dtype,
device and ``requires_grad``: a shape mismatch raises, a dtype mismatch
warns and casts (DESIGN.md §4).
"""
from __future__ import annotations

import os
import re
import warnings
import zlib
from typing import Any

import torch

from repro_torch.optim.tree import leaves, unflatten

from . import _msgpack

# payload format version: 2 added the per-array CRC32 ``manifest``;
# format-1 files (no manifest) still restore, with an "unverified" warning
CKPT_FORMAT = 2

# numpy's dtype strings (little-endian), the JAX package's tags
_TAGS = {
    torch.float32: "<f4", torch.float64: "<f8", torch.float16: "<f2",
    torch.bfloat16: "bfloat16", torch.int64: "<i8", torch.int32: "<i4",
    torch.int16: "<i2", torch.int8: "|i1", torch.uint8: "|u1",
    torch.bool: "|b1",
}
_DTYPES = {tag: dt for dt, tag in _TAGS.items()}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed verification (truncated payload, CRC
    mismatch, or structural damage)."""


class MissingLeafError(KeyError):
    """A template leaf absent from the checkpoint; carries the leaf path so
    callers (e.g. layout migrations) don't parse the message text."""

    def __init__(self, leaf_path: str):
        super().__init__(f"checkpoint missing leaf {leaf_path}")
        self.leaf_path = leaf_path


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:010d}.msgpack")


def _fsync_dir(directory: str) -> None:
    """fsync the directory so the ``os.replace`` rename is durable."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return  # platforms that can't open directories: best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def leaf_keys(tree: Any, prefix: str = "") -> list[str]:
    """``jax.tree_util.keystr`` of every leaf, in ``optim.tree.leaves``
    order (JAX's flattening order)."""
    if isinstance(tree, dict):
        return [k for key in sorted(tree)
                for k in leaf_keys(tree[key], f"{prefix}[{key!r}]")]
    if isinstance(tree, (list, tuple)):
        return [k for i, v in enumerate(tree)
                for k in leaf_keys(v, f"{prefix}[{i}]")]
    return [prefix]


def host_snapshot(tree: Any) -> Any:
    """A copy of a tree of tensors on the host, taken with one copy per
    device: each device's leaves are packed into one byte buffer (8-byte
    aligned) that is copied once; the leaves come back as views of it.
    Always a copy, so later in-place updates of the live tree (Adam's)
    cannot tear the snapshot: the contract of the async writer."""
    flat = leaves(tree)
    out: list = [None] * len(flat)
    by_device: dict = {}
    for i, t in enumerate(flat):
        if not torch.is_tensor(t):
            raise TypeError(f"checkpoint leaves are tensors, got "
                            f"{type(t).__name__}")
        by_device.setdefault(t.device, []).append(i)
    for device, idx in by_device.items():
        pad = torch.zeros(8, dtype=torch.uint8, device=device)
        parts, offsets, off = [], [], 0
        for i in idx:
            raw = flat[i].detach().contiguous().reshape(-1).view(torch.uint8)
            parts.append(raw)
            offsets.append(off)
            off += raw.numel()
            if off % 8:
                parts.append(pad[:8 - off % 8])
                off += 8 - off % 8
        buf = torch.cat(parts) if parts else pad[:0]
        if buf.device.type != "cpu":
            buf = buf.cpu()
        for i, o in zip(idx, offsets):
            t = flat[i]
            n = t.numel() * t.element_size()
            out[i] = buf[o:o + n].view(t.dtype).reshape(t.shape)
    return unflatten(tree, out)


def _record(t: torch.Tensor) -> tuple[dict, int]:
    """A CPU leaf -> its ``arrays`` record and CRC32."""
    if t.dtype not in _TAGS:
        raise TypeError(f"no checkpoint dtype tag for {t.dtype}")
    data = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return ({"dtype": _TAGS[t.dtype], "shape": list(t.shape),
             "data": data}, zlib.crc32(data))


def save_checkpoint(
    directory: str,
    step: int,
    tree: Any,
    *,
    keep: int = 3,
    extra_meta: dict | None = None,
) -> str:
    """Atomically write ``ckpt_<step>.msgpack``; prune to ``keep`` newest
    VALID checkpoints (corrupt files never count toward K)."""
    os.makedirs(directory, exist_ok=True)
    arrays = {}
    manifest = {}
    for key, leaf in zip(leaf_keys(tree), leaves(host_snapshot(tree))):
        arrays[key], manifest[key] = _record(leaf)
    payload = _msgpack.packb({
        "format": CKPT_FORMAT,
        "step": step,
        "meta": extra_meta or {},
        "manifest": manifest,
        "arrays": arrays,
    })
    final = _ckpt_path(directory, step)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    _fsync_dir(directory)
    prune_checkpoints(directory, keep)
    return final


def prune_checkpoints(directory: str, keep: int) -> list[int]:
    """Keep the newest ``keep`` checksummed-COMPLETE checkpoints.

    Only verified-complete files count toward K and only they (plus
    corrupt files older than the oldest kept one) are deleted,
    oldest-first.  A corrupt *newer* file is left in place: restore skips
    it anyway.  Returns the deleted steps.
    """
    steps = list_checkpoints(directory)
    valid = [s for s in steps if verify_checkpoint(_ckpt_path(directory, s))]
    kept = set(valid[-keep:]) if keep > 0 else set()
    cutoff = min(kept) if kept else None
    deleted = []
    for s in steps:
        if s in kept:
            continue
        if s in valid or (cutoff is not None and s < cutoff):
            try:
                os.remove(_ckpt_path(directory, s))
                deleted.append(s)
            except OSError:
                pass  # already gone (concurrent prune): fine
    return deleted


def list_checkpoints(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d{10})\.msgpack", name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    steps = list_checkpoints(directory)
    return steps[-1] if steps else None


def _read_payload(path: str, *, verify: bool = True) -> dict:
    """Read + structurally validate one checkpoint file.

    Raises :class:`CheckpointCorruptError` on truncation, structural
    damage, or (format 2) any per-array CRC32 mismatch.  Format-1 files
    (no manifest) pass with a warning: there is nothing to verify against.
    """
    with open(path, "rb") as f:
        raw = f.read()
    try:
        payload = _msgpack.unpackb(raw)
    except (ValueError, UnicodeDecodeError) as exc:
        raise CheckpointCorruptError(
            f"{path}: unreadable payload ({type(exc).__name__}: {exc})"
        ) from exc
    if not isinstance(payload, dict) or "arrays" not in payload \
            or "step" not in payload:
        raise CheckpointCorruptError(f"{path}: malformed payload structure")
    if not verify:
        return payload
    manifest = payload.get("manifest")
    if manifest is None:
        warnings.warn(
            f"{path}: legacy (format-1) checkpoint has no checksum "
            "manifest; restoring UNVERIFIED", stacklevel=3)
        return payload
    arrays = payload["arrays"]
    if not isinstance(manifest, dict) or not isinstance(arrays, dict) \
            or set(manifest) != set(arrays):
        raise CheckpointCorruptError(
            f"{path}: manifest/array key mismatch")
    for key, crc in manifest.items():
        rec = arrays[key]
        if not isinstance(rec, dict) or not isinstance(rec.get("data"),
                                                       bytes):
            raise CheckpointCorruptError(f"{path}: malformed record {key}")
        if zlib.crc32(rec["data"]) != crc:
            raise CheckpointCorruptError(
                f"{path}: CRC32 mismatch for {key} (bit-flip or torn write)")
    return payload


def verify_checkpoint(path: str) -> bool:
    """True iff the file parses and every array matches its checksum."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _read_payload(path)
        return True
    except (CheckpointCorruptError, OSError):
        return False


def latest_valid_step(directory: str) -> int | None:
    """Newest step whose checkpoint file passes verification."""
    for s in reversed(list_checkpoints(directory)):
        if verify_checkpoint(_ckpt_path(directory, s)):
            return s
    return None


def _leaf(rec: dict, key: str, like: torch.Tensor) -> torch.Tensor:
    """One ``arrays`` record as a tensor like the template leaf ``like``
    (its dtype, device and ``requires_grad``)."""
    if rec["dtype"] not in _DTYPES:
        raise ValueError(f"unknown dtype {rec['dtype']!r} for {key}")
    dtype = _DTYPES[rec["dtype"]]
    shape = tuple(rec["shape"])
    if shape != tuple(like.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {shape} vs "
                         f"template {tuple(like.shape)}")
    data = rec["data"]
    t = (torch.frombuffer(bytearray(data), dtype=dtype) if data
         else torch.empty(0, dtype=dtype)).reshape(shape)
    # the dtype is VERIFIED against the template, never silently adopted:
    # a mismatch (an f32 checkpoint into a bf16 policy, or the reverse)
    # casts to the template dtype with a warning (DESIGN.md §4)
    if dtype != like.dtype:
        warnings.warn(
            f"checkpoint dtype mismatch for {key}: stored "
            f"{rec['dtype']}, template {_TAGS.get(like.dtype, like.dtype)}; "
            "casting", stacklevel=3)
        t = t.to(like.dtype)
    return t.to(like.device).requires_grad_(like.requires_grad)


def _materialize(payload: dict, template: Any) -> tuple[Any, int, dict]:
    """Apply a verified payload onto the template tree."""
    arrays = payload["arrays"]
    new = []
    for key, like in zip(leaf_keys(template), leaves(template)):
        if key not in arrays:
            raise MissingLeafError(key)
        new.append(_leaf(arrays[key], key, like))
    return unflatten(template, new), payload["step"], payload.get("meta", {})


def restore_checkpoint(
    directory: str,
    template: Any,
    *,
    step: int | None = None,
    fallback: bool | None = None,
) -> tuple[Any, int, dict]:
    """Restore into the template's structure. Returns (tree, step, meta).

    ``step=None`` (auto-resume) walks checkpoints newest -> oldest and
    restores the newest file that passes CRC verification; a truncated or
    bit-flipped latest checkpoint is skipped with a warning.  An explicit
    ``step`` never falls back (``fallback`` overrides either default).
    Template mismatches (:class:`MissingLeafError`, shape errors) are not
    fallback events: they mean the wrong template, and re-raise.
    """
    if fallback is None:
        fallback = step is None
    if step is None:
        candidates = list(reversed(list_checkpoints(directory)))
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    else:
        candidates = [step]
    last_exc: Exception | None = None
    for s in candidates:
        path = _ckpt_path(directory, s)
        try:
            payload = _read_payload(path)
        except (CheckpointCorruptError, OSError) as exc:
            if not fallback:
                raise
            warnings.warn(
                f"skipping invalid checkpoint step {s}: {exc}; "
                "falling back to the next-newest valid one", stacklevel=2)
            last_exc = exc
            continue
        return _materialize(payload, template)
    raise CheckpointCorruptError(
        f"no valid checkpoint in {directory} "
        f"(tried {len(candidates)}; last error: {last_exc})")
