"""The MessagePack subset of a checkpoint's meta map, encoded and decoded
by hand: maps (fixmap, map16), arrays (fixarray, array16), strings
(fixstr, str8, str16) and non-negative integers (positive fixint, uint8,
uint16, uint32). ``packb`` writes the bytes ``msgpack.packb`` writes for
such a value, smallest form first; ``unpackb`` reads them back and raises
``ValueError`` on anything else, on truncation and on trailing bytes.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _head(n: int, fix: int, fix_max: int, codes, out: bytearray,
          what: str) -> None:
    if n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack_meta: {what} of length {n} is too long")


def _pack(obj: Any, out: bytearray) -> None:
    if isinstance(obj, bool) or obj is None:
        raise ValueError(f"msgpack_meta: cannot encode {obj!r}")
    if isinstance(obj, int):
        if obj < 0:
            raise ValueError(f"msgpack_meta: negative integer {obj}")
        if obj < 0x80:
            out.append(obj)
        elif obj < 1 << 8:
            out += b"\xcc" + struct.pack(">B", obj)
        elif obj < 1 << 16:
            out += b"\xcd" + struct.pack(">H", obj)
        elif obj < 1 << 32:
            out += b"\xce" + struct.pack(">I", obj)
        else:
            raise ValueError(f"msgpack_meta: integer {obj} is too large")
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _head(len(b), 0xa0, 31, ((0xd9, ">B", 1 << 8),
                                 (0xda, ">H", 1 << 16)), out, "string")
        out += b
    elif isinstance(obj, (list, tuple)):
        _head(len(obj), 0x90, 15, ((0xdc, ">H", 1 << 16),), out, "array")
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _head(len(obj), 0x80, 15, ((0xde, ">H", 1 << 16),), out, "map")
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise ValueError(f"msgpack_meta: cannot encode a "
                         f"{type(obj).__name__}")


def unpackb(data: bytes) -> Any:
    obj, end = _unpack(memoryview(bytes(data)), 0)
    if end != len(data):
        raise ValueError(f"msgpack_meta: {len(data) - end} trailing bytes")
    return obj


def _take(buf, pos: int, n: int) -> Tuple[bytes, int]:
    if pos + n > len(buf):
        raise ValueError("msgpack_meta: data ends inside a value")
    return bytes(buf[pos:pos + n]), pos + n


def _uint(buf, pos: int, fmt: str) -> Tuple[int, int]:
    raw, pos = _take(buf, pos, struct.calcsize(fmt))
    return struct.unpack(fmt, raw)[0], pos


_UINTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I"}
_STRS = {0xd9: ">B", 0xda: ">H"}


def _unpack(buf, pos: int) -> Tuple[Any, int]:
    code, pos = _uint(buf, pos, ">B")
    if code < 0x80:
        return code, pos
    if code in _UINTS:
        return _uint(buf, pos, _UINTS[code])
    if 0xa0 <= code <= 0xbf or code in _STRS:
        n, pos = ((code & 0x1f, pos) if code <= 0xbf
                  else _uint(buf, pos, _STRS[code]))
        raw, pos = _take(buf, pos, n)
        try:
            return raw.decode("utf-8"), pos
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack_meta: bad string: {e}") from None
    if 0x90 <= code <= 0x9f or code == 0xdc:
        n, pos = ((code & 0x0f, pos) if code <= 0x9f
                  else _uint(buf, pos, ">H"))
        items = []
        for _ in range(n):
            x, pos = _unpack(buf, pos)
            items.append(x)
        return items, pos
    if 0x80 <= code <= 0x8f or code == 0xde:
        n, pos = ((code & 0x0f, pos) if code <= 0x8f
                  else _uint(buf, pos, ">H"))
        out = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos)
            v, pos = _unpack(buf, pos)
            if not isinstance(k, (str, int)):
                raise ValueError("msgpack_meta: unhashable map key")
            out[k] = v
        return out, pos
    raise ValueError(f"msgpack_meta: type byte 0x{code:02x} is outside the "
                     "checkpoint meta subset")
