"""The msgpack subset that flax's `params.msgpack` uses, encoded and
decoded here so that the port needs no `msgpack` package: nil, booleans,
integers, floats, strings, binary, arrays, maps and extension types
(https://github.com/msgpack/msgpack/blob/master/spec.md).

flax writes the parameter tree as nested maps with string keys, each array
an extension of type 1 whose payload is itself msgpack: the array
[shape, dtype name, C-order bytes]; a numpy scalar is type 3 with the same
payload. `pack` writes what `msgpack.packb(..., use_bin_type=True)` writes
for these types; `unpack` reads every type of the format.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Optional


class ExtType:
    """An extension value the `ext_hook` of `unpack` did not convert."""

    def __init__(self, code: int, data: bytes):
        self.code, self.data = code, data

    def __eq__(self, other):
        return (isinstance(other, ExtType) and other.code == self.code
                and other.data == self.data)


def _pack_into(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj & 0xff)
        elif obj >= 0:
            for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                   (0xce, ">I", 1 << 32),
                                   (0xcf, ">Q", 1 << 64)):
                if obj < top:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    return
            raise OverflowError(f"{obj} does not fit in 64 bits")
        else:
            for code, fmt, bits in ((0xd0, ">b", 7), (0xd1, ">h", 15),
                                    (0xd2, ">i", 31), (0xd3, ">q", 63)):
                if obj >= -(1 << bits):
                    out += bytes([code]) + struct.pack(fmt, obj)
                    return
            raise OverflowError(f"{obj} does not fit in 64 bits")
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode()
        n = len(data)
        if n < 32:
            out.append(0xa0 | n)
        else:
            out += _length(n, (0xd9, 0xda, 0xdb))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out += _length(len(data), (0xc4, 0xc5, 0xc6)) + data
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out += bytes([0x90 | n]) if n < 16 else _length(n, (None, 0xdc, 0xdd))
        for item in obj:
            _pack_into(out, item)
    elif isinstance(obj, dict):
        n = len(obj)
        out += bytes([0x80 | n]) if n < 16 else _length(n, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack_into(out, k)
            _pack_into(out, v)
    elif isinstance(obj, ExtType):
        n = len(obj.data)
        fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        head = (bytes([fixed[n]]) if n in fixed
                else _length(n, (0xc7, 0xc8, 0xc9)))
        out += head + struct.pack(">b", obj.code) + obj.data
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _length(n: int, codes) -> bytes:
    """The header of a sized value: 8-, 16- or 32-bit length (a None code:
    no 8-bit form)."""
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit in 32 bits")


def pack(obj: Any) -> bytes:
    out = bytearray()
    _pack_into(out, obj)
    return bytes(out)


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}


class _Reader:
    def __init__(self, data, ext_hook):
        self.data, self.pos, self.ext_hook = memoryview(data), 0, ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int):
        code = self.num(">b")
        data = bytes(self.take(n))
        return self.ext_hook(code, data) if self.ext_hook else ExtType(code,
                                                                       data)

    def value(self):
        b = self.num(">B")
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return bytes(self.take(b & 0x1f)).decode()
        if b in _FIXED:
            return self.num(_FIXED[b])
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.num((">B", ">H", ">I")[b - 0xc4])))
        if b in (0xc7, 0xc8, 0xc9):
            return self.ext(self.num((">B", ">H", ">I")[b - 0xc7]))
        if 0xd4 <= b <= 0xd8:
            return self.ext(1 << (b - 0xd4))
        if b in (0xd9, 0xda, 0xdb):
            n = self.num((">B", ">H", ">I")[b - 0xd9])
            return bytes(self.take(n)).decode()
        if b in (0xdc, 0xdd):
            n = self.num(">H" if b == 0xdc else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self.map(self.num(">H" if b == 0xde else ">I"))
        raise ValueError(f"byte 0x{b:02x} starts no msgpack value")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpack(data: bytes, ext_hook: Optional[Callable] = None) -> Any:
    """One msgpack value from `data`; `ext_hook(code, data)` converts each
    extension value (else it stays an `ExtType`). Strings are decoded as
    UTF-8, arrays become lists."""
    reader = _Reader(data, ext_hook)
    value = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack value")
    return value
