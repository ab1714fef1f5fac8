"""The subset of MessagePack that the reference's checkpoint payload
uses: maps, arrays, bin and str, ints, booleans, floats and nil.

The reference writes with ``msgpack.packb(use_bin_type=True)`` and
reads with ``msgpack.unpackb(raw=True)``; the machine with the card has
no ``msgpack``, so the port keeps this small codec of its own.  Python
``bytes`` pack as bin, ``str`` as str; ``unpack`` returns str payloads
as ``bytes`` (``raw=True``), as the reference reads them.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: a fix code under ``fix_max``, else the 8-, 16-
    or 32-bit form (``codes`` maps each width to its code, None where
    the type has no such form)."""
    if n < fix_max and fix is not None:
        out.append(fix | n)
        return
    for width, fmt in ((1, ">B"), (2, ">H"), (4, ">I")):
        code = codes.get(width)
        if code is not None and n < (1 << (8 * width)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj & 0xFF)
        elif 0 <= obj < 1 << 64:
            for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if obj < lim:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
        elif -(1 << 63) <= obj < 0:
            for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                   (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
                if obj >= -lim:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
        else:
            raise ValueError(f"integer {obj} does not fit msgpack")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _head(out, len(data), None, 0, {1: 0xC4, 2: 0xC5, 4: 0xC6})
        out += data
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 32, {1: 0xD9, 2: 0xDA, 4: 0xDB})
        out += data
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, {2: 0xDC, 4: 0xDD})
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, {2: 0xDE, 4: 0xDF})
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_SIZED = {  # code -> (struct format of the length, kind)
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}
_SCALARS = {  # code -> struct format
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}


def _unpack(buf: memoryview, i: int) -> Tuple[Any, int]:
    code = buf[i]
    i += 1
    if code <= 0x7F:
        return code, i
    if code >= 0xE0:
        return code - 0x100, i
    if 0x80 <= code <= 0x8F:
        return _items(buf, i, code & 0x0F, "map")
    if 0x90 <= code <= 0x9F:
        return _items(buf, i, code & 0x0F, "array")
    if 0xA0 <= code <= 0xBF:
        n = code & 0x1F
        return bytes(buf[i:i + n]), i + n
    if code == 0xC0:
        return None, i
    if code in (0xC2, 0xC3):
        return code == 0xC3, i
    if code in _SCALARS:
        fmt = _SCALARS[code]
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, buf[i:i + size])[0], i + size
    if code in _SIZED:
        fmt, kind = _SIZED[code]
        size = struct.calcsize(fmt)
        (n,) = struct.unpack(fmt, buf[i:i + size])
        i += size
        if kind in ("bin", "str"):
            return bytes(buf[i:i + n]), i + n
        return _items(buf, i, n, kind)
    raise ValueError(f"msgpack code 0x{code:02x} is not used by checkpoints")


def _items(buf: memoryview, i: int, n: int, kind: str) -> Tuple[Any, int]:
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            out.append(v)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i


def unpackb(data: bytes) -> Any:
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes")
    return obj
