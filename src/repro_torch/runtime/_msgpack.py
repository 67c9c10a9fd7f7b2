"""The subset of MessagePack that checkpoint format 2 uses, in plain Python.

``packb`` writes what ``msgpack.packb(obj, use_bin_type=True)`` writes for
maps, str, bin, int, float, bool, nil and arrays: the smallest format of
each (fixint / fixstr / fixmap / fixarray first), big-endian lengths, a
Python float as a float 64.  ``unpackb`` reads what ``msgpack.unpackb(b,
raw=False)`` reads for those types (and float 32): str decoded as UTF-8,
bin as ``bytes``, arrays as lists, maps as dicts with str or bytes keys.
It raises ``ValueError`` on truncated input, trailing bytes, an unknown
or unsupported type byte, or a map key of another type.  The port carries
its own codec so that every machine it runs on reads and writes the same
checkpoints without the ``msgpack`` package.
"""
from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]


def _pack_int(x: int, out: list) -> None:
    if x >= 0:
        if x < 0x80:
            out.append(bytes((x,)))
        elif x < 0x100:
            out.append(b"\xcc" + struct.pack(">B", x))
        elif x < 0x10000:
            out.append(b"\xcd" + struct.pack(">H", x))
        elif x < 0x100000000:
            out.append(b"\xce" + struct.pack(">I", x))
        elif x < 0x10000000000000000:
            out.append(b"\xcf" + struct.pack(">Q", x))
        else:
            raise OverflowError(f"int {x} does not fit in 64 bits")
    elif x >= -32:
        out.append(struct.pack(">b", x))
    elif x >= -0x80:
        out.append(b"\xd0" + struct.pack(">b", x))
    elif x >= -0x8000:
        out.append(b"\xd1" + struct.pack(">h", x))
    elif x >= -0x80000000:
        out.append(b"\xd2" + struct.pack(">i", x))
    elif x >= -0x8000000000000000:
        out.append(b"\xd3" + struct.pack(">q", x))
    else:
        raise OverflowError(f"int {x} does not fit in 64 bits")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple,
              out: list) -> None:
    """The header of a str / bin / array / map of ``n`` items: a fix
    format below ``fix_max`` (when the type has one), else 8-, 16- or
    32-bit lengths (``codes``; None where the type has no such format)."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
    elif codes[0] is not None and n < 0x100:
        out.append(bytes((codes[0], n)))
    elif n < 0x10000:
        out.append(bytes((codes[1],)) + struct.pack(">H", n))
    elif n < 0x100000000:
        out.append(bytes((codes[2],)) + struct.pack(">I", n))
    else:
        raise ValueError(f"length {n} does not fit in 32 bits")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} object")


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes (``msgpack.packb(obj,
    use_bin_type=True)`` for the supported types)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated MessagePack data: {n} bytes wanted "
                             f"at offset {self.pos} of {len(self.data)}")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-width scalars after a type byte: (struct format)
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# variable-length types: type byte -> (kind, struct format of the length)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(r: _Reader):
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif 0x90 <= b <= 0x9F:
        kind, n = "array", b & 0x0F
    elif 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif b == 0xC0:
        return None
    elif b == 0xC2:
        return False
    elif b == 0xC3:
        return True
    elif b in _SCALARS:
        return r.unpack(_SCALARS[b])
    elif b in _SIZED:
        kind, fmt = _SIZED[b]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"map key of type {type(k).__name__}")
        out[k] = _unpack(r)
    return out


def unpackb(data: bytes):
    """The object in MessagePack ``data`` (``msgpack.unpackb(data,
    raw=False)`` for the supported types); the whole input must be one
    object."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of trailing data "
                         "after the MessagePack object")
    return obj
