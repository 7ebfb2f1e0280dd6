"""The subset of MessagePack that a checkpoint manifest uses, written
with the standard library: maps, arrays, strings, integers (fixint to
int64/uint64), floats (always written as float64), booleans and nil.

``packb`` gives the bytes that ``msgpack.packb`` gives with its defaults
for these types (the smallest integer and length formats, str8 for
strings of 32-255 bytes, a dict's insertion order, tuples as arrays);
``unpackb`` reads them back as ``msgpack.unpackb`` does (arrays as
lists, strings as ``str``), and also reads float32 and the bin formats.
Anything else raises ``TypeError`` (packing) or ``ValueError``
(unpacking: unknown format, truncated input, trailing bytes).
"""
from __future__ import annotations

import struct
from typing import Any, List


def _int(n: int, out: List[bytes]) -> None:
    if 0 <= n <= 0x7F:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif n > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"integer {n} does not fit in uint64")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"integer {n} does not fit in int64")


def _length(n: int, fix: int, fix_max: int, codes, out: List[bytes]) -> None:
    """The header of a str/array/map of ``n`` items: the fix form up to
    ``fix_max``, then the 8-bit (str only), 16-bit and 32-bit forms."""
    if n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in codes:
        if n <= top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} is too long for msgpack")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_ARR = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _length(len(data), 0xA0, 31, _STR, out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _length(len(obj), 0x90, 15, _ARR, out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _length(len(obj), 0x80, 15, _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack bytes."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("Unpack failed: incomplete input")
        chunk = bytes(self.data[self.pos:end])
        self.pos = end
        return chunk

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


#: fixed-size formats: code -> struct format
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
#: length-prefixed formats: code -> (kind, length format)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("arr", ">H"), 0xDD: ("arr", ">I"), 0xDE: ("map", ">H"),
          0xDF: ("map", ">I")}


def _unpack(r: _Reader) -> Any:
    code = r.take(1)[0]
    if code <= 0x7F:
        return code
    if code >= 0xE0:
        return code - 0x100
    if 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif 0x90 <= code <= 0x9F:
        kind, n = "arr", code & 0x0F
    elif 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif code == 0xC0:
        return None
    elif code in (0xC2, 0xC3):
        return code == 0xC3
    elif code in _SCALARS:
        return r.num(_SCALARS[code])
    elif code in _SIZED:
        kind, fmt = _SIZED[code]
        n = r.num(fmt)
    else:
        raise ValueError(f"Unpack failed: unsupported format 0x{code:02x}")
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "bin":
        return r.take(n)
    if kind == "arr":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        key = _unpack(r)
        if not isinstance(key, (str, bytes)):
            raise ValueError(f"{type(key).__name__} is not allowed for map "
                             f"key")
        out[key] = _unpack(r)
    return out


def unpackb(data: bytes) -> Any:
    """The one object in ``data``; raises ``ValueError`` on truncated or
    trailing bytes."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError(f"Unpack failed: {len(r.data) - r.pos} bytes of "
                         f"extra data")
    return obj
