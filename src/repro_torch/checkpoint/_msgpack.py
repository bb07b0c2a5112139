"""MessagePack for the checkpoint container and the cluster's manifest.

The port's own packer and unpacker, in pure Python, for the subset the
two formats use: nil, bool, int, float64, str, bin, array and map.
:func:`packb` gives the bytes ``msgpack.packb(obj, use_bin_type=True)``
gives for these types (smallest encoding of each int and length, floats
always 64-bit, ``bytes`` as bin, lists and tuples as arrays, maps in
insertion order); :func:`unpackb` reads them back as
``msgpack.unpackb(data, raw=False)`` does (str decoded, bin as
``bytes``, arrays as lists), and also reads a float32.
"""

from __future__ import annotations

import struct
from typing import Any, List

__all__ = ["header", "packb", "unpackb"]

_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def _int(out: List[bytes], n: int) -> None:
    if n < -(1 << 5):
        if n < -(1 << 15):
            if n < -(1 << 31):
                if n < -(1 << 63):
                    raise OverflowError(f"int too small to pack: {n}")
                out.append(b"\xd3" + _I64.pack(n))
            else:
                out.append(b"\xd2" + _I32.pack(n))
        elif n < -(1 << 7):
            out.append(b"\xd1" + _I16.pack(n))
        else:
            out.append(b"\xd0" + _I8.pack(n))
    elif n < (1 << 7):
        out.append(_U8.pack(n & 0xFF))  # positive or negative fixint
    elif n < (1 << 8):
        out.append(b"\xcc" + _U8.pack(n))
    elif n < (1 << 16):
        out.append(b"\xcd" + _U16.pack(n))
    elif n < (1 << 32):
        out.append(b"\xce" + _U32.pack(n))
    elif n < (1 << 64):
        out.append(b"\xcf" + _U64.pack(n))
    else:
        raise OverflowError(f"int too large to pack: {n}")


def _header(out: List[bytes], n: int, fix: int, fix_max: int,
            codes: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else the
    smallest of the 8- (when the type has one), 16- and 32-bit forms."""
    if n < fix_max:
        out.append(_U8.pack(fix | n))
        return
    c8, c16, c32 = codes
    if c8 is not None and n < (1 << 8):
        out.append(bytes((c8,)) + _U8.pack(n))
    elif n < (1 << 16):
        out.append(bytes((c16,)) + _U16.pack(n))
    elif n < (1 << 32):
        out.append(bytes((c32,)) + _U32.pack(n))
    else:
        raise ValueError(f"object too large to pack: {n} entries")


def _pack(out: List[bytes], obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _int(out, int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = obj if isinstance(obj, bytes) else memoryview(obj).tobytes()
        _header(out, len(data), 0, 0, (0xC4, 0xC5, 0xC6))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for x in obj:
            _pack(out, x)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def header(kind: str, n: int) -> bytes:
    """The header of a map (``kind="map"``) of ``n`` pairs, an array
    (``"array"``) of ``n`` items or a bin (``"bin"``) of ``n`` bytes:
    :func:`packb` of one is this header followed by its packed items (or
    its bytes), so a writer can emit a long one piece by piece."""
    out: List[bytes] = []
    if kind == "map":
        _header(out, n, 0x80, 16, (None, 0xDE, 0xDF))
    elif kind == "array":
        _header(out, n, 0x90, 16, (None, 0xDC, 0xDD))
    elif kind == "bin":
        _header(out, n, 0, 0, (0xC4, 0xC5, 0xC6))
    else:
        raise ValueError(f"no header kind {kind!r}")
    return b"".join(out)


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack bytes (``msgpack.packb(obj,
    use_bin_type=True)`` for the supported types)."""
    out: List[bytes] = []
    _pack(out, obj)
    return b"".join(out)


#: type byte → (what follows, the struct of its number or length)
_CODES = {
    0xC4: ("bin", _U8), 0xC5: ("bin", _U16), 0xC6: ("bin", _U32),
    0xCA: ("num", _F32), 0xCB: ("num", _F64),
    0xCC: ("num", _U8), 0xCD: ("num", _U16), 0xCE: ("num", _U32),
    0xCF: ("num", _U64),
    0xD0: ("num", _I8), 0xD1: ("num", _I16), 0xD2: ("num", _I32),
    0xD3: ("num", _I64),
    0xD9: ("str", _U8), 0xDA: ("str", _U16), 0xDB: ("str", _U32),
    0xDC: ("array", _U16), 0xDD: ("array", _U32),
    0xDE: ("map", _U16), 0xDF: ("map", _U32),
}


class _Reader:
    def __init__(self, data) -> None:
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated MessagePack data")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def num(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]

    def obj(self) -> Any:
        b = self.num(_U8)
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.read("map", b & 0x0F)
        if b < 0xA0:
            return self.read("array", b & 0x0F)
        if b < 0xC0:
            return self.read("str", b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b not in _CODES:
            raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")
        kind, st = _CODES[b]
        n = self.num(st)
        return n if kind == "num" else self.read(kind, n)

    def read(self, kind: str, n: int) -> Any:
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "array":
            return [self.obj() for _ in range(n)]
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data) -> Any:
    """One MessagePack object from ``data`` (``msgpack.unpackb(data,
    raw=False)`` for the supported types); extra bytes raise."""
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("extra data after the MessagePack object")
    return obj
