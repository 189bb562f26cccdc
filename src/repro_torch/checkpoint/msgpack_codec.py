"""MessagePack for the checkpoint store, without the ``msgpack`` package
(the card's machine does not have it).

Covers what ``checkpoint.store`` writes: maps, arrays (lists and tuples),
str, bin (bytes, bytearray, memoryview), bool, nil, ints from -2**63 to
2**64 - 1 and floats (float64).  ``packb`` produces the bytes that
``msgpack.packb(obj, use_bin_type=True)`` produces: each value takes the
shortest encoding of its family, and maps keep their iteration order.
``unpackb`` reads those families (float32 too) as
``msgpack.unpackb(data, raw=False)`` does: arrays as lists, str as str,
bin as bytes."""
from __future__ import annotations

import struct


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int,
              codes: tuple) -> None:
    """A length header: the fix form below ``fix_max`` (if any), else the
    first of the 8/16/32-bit ``codes`` that holds ``n``."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, lim in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif v >= 0:
        for code, fmt, lim in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} too large")
    elif v >= -32:
        out.append(v & 0xff)
    else:
        for code, fmt, lim in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                               (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if v >= -lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} too small")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True:
        out.append(0xc3)
    elif obj is False:
        out.append(0xc2)
    elif isinstance(obj, int) and not isinstance(obj, bool):
        _pack_int(out, int(obj))
    elif isinstance(obj, float):
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = memoryview(obj).cast("B")
        _pack_len(out, len(b), None, 0, (0xc4, 0xc5, 0xc6))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: data ends inside a value")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_UINT = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
         0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
         0xca: ">f", 0xcb: ">d"}
_LEN = {0xd9: ">B", 0xda: ">H", 0xdb: ">I",        # str
        0xc4: ">B", 0xc5: ">H", 0xc6: ">I",        # bin
        0xdc: ">H", 0xdd: ">I",                    # array
        0xde: ">H", 0xdf: ">I"}                    # map


def _unpack(r: _Reader):
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_unpack(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return str(r.take(b & 0x1f), "utf-8")
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _UINT:
        return r.num(_UINT[b])
    if b in _LEN:
        n = r.num(_LEN[b])
        if b in (0xd9, 0xda, 0xdb):
            return str(r.take(n), "utf-8")
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(r.take(n))
        if b in (0xdc, 0xdd):
            return [_unpack(r) for _ in range(n)]
        return _map(r, n)
    raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def unpackb(data):
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError("msgpack: extra data after the value")
    return obj
