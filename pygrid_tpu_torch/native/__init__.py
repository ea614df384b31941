"""Native host-side kernels with transparent numpy fallbacks: the port's
own copy of :mod:`pygrid_tpu.native`, with the same C++ source
(``src/pygrid_native.cpp``) and the same entry points.

Parity surface: the reference's native serving hot spots — wsaccel's C
websocket masking (``apps/node/pyproject.toml:31``) and the numpy XOR
masking patch it applies over geventwebsocket
(``apps/node/src/app/util.py:5-24``, installed at
``app/__init__.py:19-21``) — plus the protobuf C++ tensor payload packing.
Additions: float32↔bfloat16 wire conversion (round-to-nearest-even, as
``torch.bfloat16`` rounds) so FL diffs and checkpoints can travel at half
width.

Every entry point works without the compiled library (numpy fallbacks;
the bf16 ones are bit arithmetic on the uint32 view, where the JAX package
uses ``ml_dtypes``); ``BACKEND`` says which implementation is live."""

from __future__ import annotations

import ctypes
from typing import Any

import numpy as np

from pygrid_tpu_torch.native.build import ensure_built

__all__ = [
    "BACKEND",
    "xor_mask",
    "xor_mask_inplace",
    "b64_decode",
    "b64_decode_view",
    "f32_to_bf16",
    "bf16_to_f32",
    "accum_f32",
    "accum_bf16",
    "install_ws_masking",
]

_lib: Any = None
BACKEND = "numpy"


def _load() -> None:
    global _lib, BACKEND
    path = ensure_built()
    if path is None:
        return
    try:
        lib = ctypes.CDLL(str(path))
        lib.pg_xor_mask.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p
        ]
        lib.pg_f32_to_bf16.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64
        ]
        lib.pg_bf16_to_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64
        ]
        lib.pg_accum_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double, ctypes.c_uint64
        ]
        lib.pg_accum_bf16.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double, ctypes.c_uint64
        ]
        lib.pg_b64_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p
        ]
        lib.pg_b64_decode.restype = ctypes.c_int64
        lib.pg_abi_version.restype = ctypes.c_int
        if lib.pg_abi_version() == 2:
            _lib = lib
            BACKEND = "native"
    except (OSError, AttributeError):
        # AttributeError: a stale cached .so predating the current ABI is
        # missing newer symbols — fall back to numpy, don't break import
        pass


_load()


def xor_mask(data: bytes | bytearray, mask: bytes) -> bytearray:
    """Websocket frame (un)masking: ``data ^ cycle(mask4)``."""
    if len(mask) != 4:
        raise ValueError("mask must be 4 bytes")
    out = bytearray(data)
    if _lib is not None:
        buf = (ctypes.c_char * len(out)).from_buffer(out)
        _lib.pg_xor_mask(buf, len(out), mask)
        return out
    arr = np.frombuffer(out, dtype=np.uint8)
    pattern = np.frombuffer(
        (mask * (len(out) // 4 + 1))[: len(out)], dtype=np.uint8
    )
    np.bitwise_xor(arr, pattern, out=arr)
    return out


def xor_mask_inplace(
    buf: bytearray, mask: bytes, offset: int = 0
) -> None:
    """Mask ``buf[offset:]`` in place — the zero-extra-copy framing path
    (the caller already assembled the frame buffer)."""
    n = len(buf) - offset
    if n <= 0:
        return
    if _lib is not None:
        view = (ctypes.c_char * n).from_buffer(buf, offset)
        _lib.pg_xor_mask(view, n, mask)
        return
    arr = np.frombuffer(buf, dtype=np.uint8, offset=offset)
    pattern = np.frombuffer((mask * (n // 4 + 1))[:n], dtype=np.uint8)
    np.bitwise_xor(arr, pattern, out=arr)


def f32_to_bf16(arr: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 bit pattern (uint16), round-to-nearest-even."""
    src = np.ascontiguousarray(arr, dtype=np.float32)
    if src.ctypes.data % src.itemsize:
        # zero-copy wire views sit at arbitrary byte offsets and
        # ascontiguousarray does NOT realign — same hazard as bf16_to_f32
        src = src.copy()
    out = np.empty(src.shape, dtype=np.uint16)
    if _lib is not None and src.size:
        _lib.pg_f32_to_bf16(
            src.ctypes.data, out.ctypes.data, src.size
        )
        return out
    u = src.view(np.uint32)
    # round to nearest even on the 16 bits dropped; NaN keeps its top bits
    # and is quieted, as the C++ does (ml_dtypes makes every NaN 0x7fc0)
    rounded = ((u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))) >> 16).astype(np.uint16)
    quiet = ((u >> 16) | np.uint32(0x40)).astype(np.uint16)
    return np.where((u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000), quiet, rounded)


def bf16_to_f32(arr: np.ndarray) -> np.ndarray:
    """bfloat16 bit pattern (uint16) → float32 (exact)."""
    src = np.ascontiguousarray(arr, dtype=np.uint16)
    if src.ctypes.data % src.itemsize:
        # wire views can sit at any byte offset and ascontiguousarray does
        # NOT realign — same unaligned-pointer hazard as accum_f32
        src = src.copy()
    out = np.empty(src.shape, dtype=np.float32)
    if _lib is not None and src.size:
        _lib.pg_bf16_to_f32(
            src.ctypes.data, out.ctypes.data, src.size
        )
        return out
    return (src.astype(np.uint32) << np.uint32(16)).view(np.float32)


def b64_decode(data: str | bytes) -> bytes:
    """Standard-alphabet base64 decode (padding required, no whitespace),
    ~3× CPython's ``binascii`` on megabyte payloads. Raises ``ValueError``
    on malformed input."""
    return bytes(b64_decode_view(data))


def b64_decode_view(data: str | bytes) -> memoryview | bytes:
    """Like :func:`b64_decode` but returns a memoryview over a freshly
    decoded buffer — no final copy. The FL report ingest decodes ~1.7 MB
    per report; every pass skipped is protocol throughput."""
    raw = data.encode("ascii") if isinstance(data, str) else data
    if _lib is None:
        import base64 as _b64

        return _b64.b64decode(raw, validate=True)
    if len(raw) % 4:
        raise ValueError("invalid base64 payload")
    pad = 0
    if raw[-1:] == b"=":
        pad = 2 if raw[-2:] == b"==" else 1
    n_out = 3 * (len(raw) // 4) - pad
    out = np.empty(max(n_out, 1), dtype=np.uint8)  # no memset, no resize
    n = _lib.pg_b64_decode(
        raw if isinstance(raw, bytes) else bytes(raw),
        len(raw), out.ctypes.data,
    )
    if n != n_out:
        raise ValueError("invalid base64 payload")
    return memoryview(out.data)[:n_out].cast("B") if n_out else b""


def accum_f32(acc: np.ndarray, src, weight: float = 1.0) -> None:
    """``acc += weight * src`` in one pass, float64 carry, no temporaries.

    ``acc`` is a C-contiguous float64 array; ``src`` is a float32 array or
    any buffer of ``acc.size`` float32 values (e.g. a memoryview straight
    out of the wire decoder — the FL report fold never copies)."""
    if not isinstance(src, np.ndarray):
        src = np.frombuffer(src, dtype=np.float32)
    if src.size != acc.size:
        raise ValueError(f"accum_f32 size mismatch: {src.size} != {acc.size}")
    if _lib is not None and acc.size:
        src = np.ascontiguousarray(src, dtype=np.float32)
        # np.frombuffer over a msgpack blob can sit at any byte offset
        # and ascontiguousarray does NOT realign — dereferencing an
        # unaligned const float* is UB in C (works on x86-64, can trap
        # on stricter targets)
        if src.ctypes.data % src.itemsize:
            src = src.copy()
        _lib.pg_accum_f32(
            acc.ctypes.data, src.ctypes.data, float(weight), acc.size
        )
        return
    flat = acc.reshape(-1)
    if weight == 1.0:
        np.add(flat, src.reshape(-1), out=flat)
    else:
        flat += np.multiply(src.reshape(-1), weight, dtype=np.float64)


def accum_bf16(acc: np.ndarray, src, weight: float = 1.0) -> None:
    """``acc += weight * decode_bf16(src)`` fused in one pass — the bf16
    wire report accumulates without ever materializing as float32."""
    if not isinstance(src, np.ndarray):
        src = np.frombuffer(src, dtype=np.uint16)
    if src.size != acc.size:
        raise ValueError(f"accum_bf16 size mismatch: {src.size} != {acc.size}")
    if _lib is not None and acc.size:
        src = np.ascontiguousarray(src, dtype=np.uint16)
        # same unaligned-wire-offset hazard as accum_f32 above
        if src.ctypes.data % src.itemsize:
            src = src.copy()
        _lib.pg_accum_bf16(
            acc.ctypes.data, src.ctypes.data, float(weight), acc.size
        )
        return
    accum_f32(acc, bf16_to_f32(src), weight)


def install_ws_masking() -> bool:
    """Patch ``websockets``' pure-python ``apply_mask`` with the native one.

    Direct analog of the reference's masking patch (util.py:5-24). No-op
    when the library already has its C speedups or we only have numpy."""
    if _lib is None:
        return False
    try:
        from websockets import frames, utils
    except ImportError:
        return False
    # the C accelerator (when installed) is bound at frames.apply_mask with
    # __module__ "websocket.speedups" — leave it alone, it's already native
    if "speedup" in getattr(frames.apply_mask, "__module__", ""):
        return False

    def native_apply_mask(data: bytes, mask: bytes) -> bytes:
        return bytes(xor_mask(data, mask))

    utils.apply_mask = native_apply_mask
    frames.apply_mask = native_apply_mask
    return True
