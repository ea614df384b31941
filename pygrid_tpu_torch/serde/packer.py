"""The msgpack subset the wire format uses, written out in Python.

The JAX package calls the ``msgpack`` package; the machine the port runs on
need not have it, so the port carries its own writer and reader for the
types the wire uses: nil, bool, int, float, str, bin, array, map and ext.

- :func:`packb` gives the bytes of ``msgpack.packb(obj, use_bin_type=True,
  default=default)`` for every such object: the smallest integer encoding,
  float64 for every float (a ``numpy.float64`` is a float), str8 for short
  strings, tuples as arrays, ``default`` called once for anything else, in
  msgpack's order of type checks.
- :class:`Reader` reads one object at a time from a buffer, with
  ``strict_map_key=False`` semantics (any hashable key; an array key is
  unhashable and raises TypeError, as in msgpack). In ``zero_copy`` mode bin values
  and ext payloads come back as memoryview slices of the buffer and an ext
  without a hook as a ``(code, view)`` pair: the State fast path's cursor.
- :func:`unpackb` reads exactly one object and raises :class:`ExtraData`
  on trailing bytes. Truncated or malformed input raises a ``ValueError``
  (:class:`UnpackError`), as msgpack's do.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple

#: nesting past this raises ValueError on both sides (msgpack's packer
#: stops at the same depth), before Python's own recursion limit
MAX_DEPTH = 511


class _Ext(NamedTuple):
    code: int
    data: bytes


class ExtType(_Ext):
    """An ext value; like msgpack's, its code must be in 0..127 (the
    negative codes are msgpack's own, and an ext value cannot carry one)."""

    __slots__ = ()

    def __new__(cls, code: int, data: bytes):
        if not isinstance(code, int) or not 0 <= code <= 127:
            raise ValueError("code must be 0~127")
        return super().__new__(cls, code, data)


class UnpackError(ValueError):
    """Truncated, malformed or over-deep msgpack input."""


class ExtraData(UnpackError):
    """Bytes left over after the one object :func:`unpackb` reads."""

    def __init__(self, unpacked: Any, extra: bytes) -> None:
        super().__init__("unpack(b) received extra data.")
        self.unpacked = unpacked
        self.extra = extra


_D = struct.Struct(">d")
_F = struct.Struct(">f")


def _int(n: int) -> bytes:
    if n >= 0:
        if n < 0x80:
            return bytes((n,))
        if n <= 0xFF:
            return b"\xcc" + bytes((n,))
        if n <= 0xFFFF:
            return b"\xcd" + n.to_bytes(2, "big")
        if n <= 0xFFFFFFFF:
            return b"\xce" + n.to_bytes(4, "big")
        if n <= 0xFFFFFFFFFFFFFFFF:
            return b"\xcf" + n.to_bytes(8, "big")
        raise OverflowError("Integer value out of range")
    if n >= -32:
        return bytes((n + 0x100,))
    if n >= -0x80:
        return b"\xd0" + n.to_bytes(1, "big", signed=True)
    if n >= -0x8000:
        return b"\xd1" + n.to_bytes(2, "big", signed=True)
    if n >= -0x80000000:
        return b"\xd2" + n.to_bytes(4, "big", signed=True)
    if n >= -0x8000000000000000:
        return b"\xd3" + n.to_bytes(8, "big", signed=True)
    raise OverflowError("Integer value out of range")


def _head(n: int, small: int | None, small_max: int, codes: tuple[int, int, int]) -> bytes:
    """Length header: ``small | n`` up to ``small_max`` (when the family
    has a fix form), else the 8-, 16- or 32-bit form."""
    if small is not None and n <= small_max:
        return bytes((small | n,))
    c8, c16, c32 = codes
    if c8 and n <= 0xFF:
        return bytes((c8, n))
    if n <= 0xFFFF:
        return bytes((c16,)) + n.to_bytes(2, "big")
    if n <= 0xFFFFFFFF:
        return bytes((c32,)) + n.to_bytes(4, "big")
    raise ValueError("msgpack length out of range")


def _bin(data) -> bytes:
    return _head(len(data), None, 0, (0xC4, 0xC5, 0xC6))


def _ext(code: int, data) -> bytes:
    n = len(data)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    tag = struct.pack("b", code)
    if fix is not None:
        return bytes((fix,)) + tag
    return _head(n, None, 0, (0xC7, 0xC8, 0xC9)) + tag


def _pack(obj: Any, out: list, default: Callable | None, depth: int) -> None:
    if depth > MAX_DEPTH:
        raise ValueError("recursion limit exceeded")
    used_default = False
    while True:
        if obj is None:
            out.append(b"\xc0")
        elif obj is True:
            out.append(b"\xc3")
        elif obj is False:
            out.append(b"\xc2")
        elif isinstance(obj, int):
            try:
                out.append(_int(obj))
            except OverflowError:
                if used_default or default is None:
                    raise
                obj, used_default = default(obj), True
                continue
        elif isinstance(obj, float):
            out.append(b"\xcb" + _D.pack(obj))
        elif isinstance(obj, (bytes, bytearray)):
            out.append(_bin(obj))
            out.append(bytes(obj))
        elif isinstance(obj, str):
            raw = obj.encode("utf-8")
            out.append(_head(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)))
            out.append(raw)
        elif isinstance(obj, dict):
            out.append(_head(len(obj), 0x80, 15, (0, 0xDE, 0xDF)))
            for k, v in obj.items():
                _pack(k, out, default, depth + 1)
                _pack(v, out, default, depth + 1)
        elif isinstance(obj, ExtType):
            out.append(_ext(obj.code, obj.data))
            out.append(bytes(obj.data))
        elif isinstance(obj, (list, tuple)):
            out.append(_head(len(obj), 0x90, 15, (0, 0xDC, 0xDD)))
            for v in obj:
                _pack(v, out, default, depth + 1)
        elif isinstance(obj, memoryview):
            raw = obj.tobytes()
            out.append(_bin(raw))
            out.append(raw)
        elif default is not None and not used_default:
            obj, used_default = default(obj), True
            continue
        else:
            raise TypeError(f"can not serialize {type(obj).__name__!r} object")
        return


def packb(obj: Any, default: Callable | None = None) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True, default=default)``."""
    out: list = []
    _pack(obj, out, default, 0)
    return b"".join(out)


class Reader:
    """msgpack objects one at a time from ``buf`` (bytes, bytearray or
    memoryview), starting at ``pos``.

    ``ext_hook(code, payload)`` decodes ext values. ``zero_copy`` returns
    bin values and ext payloads as memoryview slices of ``buf`` (which must
    stay alive), else as bytes; with ``zero_copy`` and no hook an ext value
    is the pair ``(code, view)``."""

    __slots__ = ("buf", "pos", "ext_hook", "zero_copy")

    def __init__(self, buf, ext_hook: Callable | None = None, zero_copy: bool = False,
                 pos: int = 0) -> None:
        self.buf = memoryview(buf).cast("B")
        self.pos = pos
        self.ext_hook = ext_hook
        self.zero_copy = zero_copy

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)

    def _take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise UnpackError("Unpack failed: incomplete input")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def _u(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def _s(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big", signed=True)

    def _bin(self, n: int):
        view = self._take(n)
        return view if self.zero_copy else view.tobytes()

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _ext(self, n: int):
        code = self._s(1)
        payload = self._take(n)
        if self.ext_hook is not None:
            return self.ext_hook(code, payload if self.zero_copy else payload.tobytes())
        if self.zero_copy:
            return (code, payload)
        return ExtType(code, payload.tobytes())

    def read(self):
        """The next object; nesting past what Python's stack holds raises
        UnpackError (a ValueError), as msgpack's stack limit does."""
        try:
            return self._read(0)
        except RecursionError:
            raise UnpackError("msgpack nesting too deep") from None

    def _read(self, depth: int):  # noqa: C901 — one flat token switch
        if depth > MAX_DEPTH:
            raise UnpackError("msgpack nesting too deep")
        b = self._u(1)
        if b <= 0x7F:
            return b
        if b <= 0x8F:
            return self._map(b & 0x0F, depth)
        if b <= 0x9F:
            return self._array(b & 0x0F, depth)
        if b <= 0xBF:
            return self._str(b & 0x1F)
        if b >= 0xE0:
            return b - 0x100
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            return self._bin(self._u(1 << (b - 0xC4)))
        if b in (0xC7, 0xC8, 0xC9):
            return self._ext(self._u(1 << (b - 0xC7)))
        if b == 0xCA:
            return _F.unpack(self._take(4))[0]
        if b == 0xCB:
            return _D.unpack(self._take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self._u(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            return self._s(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self._str(self._u(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self._array(self._u(2 if b == 0xDC else 4), depth)
        if b in (0xDE, 0xDF):
            return self._map(self._u(2 if b == 0xDE else 4), depth)
        raise UnpackError(f"msgpack: reserved byte {b:#x}")

    def _array(self, n: int, depth: int) -> list:
        return [self._read(depth + 1) for _ in range(n)]

    def _map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(n):
            k = self._read(depth + 1)
            out[k] = self._read(depth + 1)  # an array key raises TypeError, as in msgpack
        return out


def unpackb(data, ext_hook: Callable | None = None):
    """``msgpack.unpackb(data, raw=False, strict_map_key=False,
    ext_hook=ext_hook)``: exactly one object, bin values as bytes."""
    reader = Reader(data, ext_hook)
    obj = reader.read()
    if not reader.at_end():
        raise ExtraData(obj, reader.buf[reader.pos:].tobytes())
    return obj
