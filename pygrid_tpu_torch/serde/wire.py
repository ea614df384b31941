"""Wire serialization for tensors, States and messages: the port's own copy
of :mod:`pygrid_tpu.serde.wire`, byte for byte the same format.

The reference delegates this to syft-0.2.9 serde + syft-proto protobufs
(consumed at reference ``models/model_manager.py:88-101`` and
``syft_assets/plan_manager.py:104-117``). Here the wire format is msgpack
(written and read by :mod:`pygrid_tpu_torch.serde.packer`, the port's own
msgpack, so that no ``msgpack`` package is needed) with these extension
codes:

- ``EXT_NDARRAY`` (0x01): ``[dtype_str, shape, raw_bytes]`` — zero-copy-able
  row-major buffer. A torch tensor on any device is copied to the host and
  written as the ndarray its numpy copy gives (a ``torch.bfloat16`` tensor
  as its raw 2-byte values with dtype string ``'<V2'``, the bytes the JAX
  package writes for an ``ml_dtypes.bfloat16`` array; either package reads
  them back as raw void ``|V2``). deserialize returns numpy (device
  placement is the caller's decision, so host↔device transfers stay
  explicit).
- ``EXT_OBJECT`` (0x02): ``[type_name, payload]`` for any class registered via
  :func:`register_serde` — the class provides ``_bufferize``/``_unbufferize``
  (names kept from the syft serde surface the reference consumes).

The format is self-contained and versioned by ``WIRE_VERSION`` so node and
client builds can interoperate across releases.
"""

from __future__ import annotations

import binascii
import inspect
import zlib
from typing import Any, Callable

import numpy as np

from pygrid_tpu_torch.serde.packer import ExtType, Reader, packb, unpackb

#: v2 adds the negotiated binary frame path: raw msgpack WS frames with a
#: one-byte codec tag (optionally zstd/zlib-compressed), negotiated per
#: connection via the ``pygrid.wire.v2`` websocket subprotocol. v1 peers
#: never offer the subprotocol and keep the hex/base64-in-JSON framing.
WIRE_VERSION = 2

EXT_NDARRAY = 0x01
EXT_OBJECT = 0x02
#: float32 array carried as bfloat16 bit patterns — half the bytes on the
#: wire; decodes back to float32. Written only when the sender opts in via
#: ``serialize(..., bf16_floats=True)``.
EXT_NDARRAY_BF16 = 0x03

# type name -> (cls, bufferize, unbufferize)
_REGISTRY: dict[str, tuple[type, Callable, Callable]] = {}
# type names whose _unbufferize takes the ``device`` to decode tensors onto
_TAKES_DEVICE: set[str] = set()
# cls -> type name
_CLS_NAMES: dict[type, str] = {}


def register_serde(cls: type | None = None, *, name: str | None = None):
    """Class decorator registering ``cls`` for wire serde.

    ``cls`` must define ``_bufferize(self) -> Any`` returning a
    msgpack-serializable structure (which may itself contain ndarrays or other
    registered objects) and a classmethod ``_unbufferize(cls, data) -> cls``.
    A class whose objects hold torch tensors (``AdditiveSharingTensor``)
    gives ``_unbufferize`` a ``device`` keyword, and :func:`deserialize`
    passes its own ``device`` on.
    """

    def _register(c: type) -> type:
        type_name = name or f"{c.__module__}.{c.__qualname__}"
        if not hasattr(c, "_bufferize") or not hasattr(c, "_unbufferize"):
            raise TypeError(f"{c} must define _bufferize/_unbufferize")
        _REGISTRY[type_name] = (c, c._bufferize, c._unbufferize)
        _CLS_NAMES[c] = type_name
        if "device" in inspect.signature(c._unbufferize).parameters:
            _TAKES_DEVICE.add(type_name)
        return c

    return _register(cls) if cls is not None else _register


def _is_torch_tensor(obj: Any) -> bool:
    mod = type(obj).__module__ or ""
    return mod.startswith("torch") and hasattr(obj, "detach") and hasattr(obj, "dtype")


def _pack_raw(dtype_str: str, shape: list, raw: bytes) -> ExtType:
    return ExtType(EXT_NDARRAY, packb([dtype_str, shape, raw]))


def _pack_ndarray(arr: np.ndarray) -> ExtType:
    arr = np.asarray(arr)
    shape = list(arr.shape)  # before ascontiguousarray: it promotes 0-d to (1,)
    return _pack_raw(arr.dtype.str, shape, np.ascontiguousarray(arr).tobytes())


def _host_leaf(obj: Any) -> np.ndarray | ExtType | None:
    """A tensor-like leaf as the host ndarray it serializes as (numpy as it
    is, a torch tensor on any device as its detached host copy), or, for a
    bf16 torch tensor, its finished ext: the raw 2-byte values under the
    dtype string ``'<V2'`` that an ``ml_dtypes.bfloat16`` array writes.
    None for anything else."""
    if isinstance(obj, (np.ndarray, np.generic)):
        return np.asarray(obj)
    if _is_torch_tensor(obj):
        import torch

        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            raw = t.contiguous().view(torch.int16).numpy().tobytes()
            return _pack_raw("<V2", list(t.shape), raw)
        return t.numpy()
    return None


#: tensor-buffer byte copies made by deserialization since process start —
#: the zero-copy regression hook: tests snapshot it around a decode and
#: assert the delta (the hot model/diff path must stay at zero).
_tensor_copies = 0


def tensor_copy_count() -> int:
    return _tensor_copies


def _count_copy() -> None:
    global _tensor_copies
    _tensor_copies += 1


def _view_f32(raw, shape) -> np.ndarray:
    """bf16 wire bits → float32, shaped. A dtype conversion, not a buffer
    copy (there is no f32 buffer on the wire to view)."""
    from pygrid_tpu_torch.native import bf16_to_f32

    return bf16_to_f32(np.frombuffer(raw, dtype=np.uint16)).reshape(shape)


def _unpack_ndarray(payload: bytes, copy: bool) -> np.ndarray:
    dtype_str, shape, raw = unpackb(payload)
    if copy:
        # bytearray copy => writable result (frombuffer over bytes is
        # read-only) — the opt-in for callers that mutate in place.
        _count_copy()
        raw = bytearray(raw)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype_str))
    if not copy:
        arr.flags.writeable = False
    return arr.reshape(shape)


def _pack_ndarray_bf16(arr: np.ndarray) -> ExtType:
    from pygrid_tpu_torch.native import f32_to_bf16

    shape = list(np.shape(arr))  # before ascontiguousarray: 0-d promotes
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    payload = packb([shape, f32_to_bf16(arr).tobytes()])
    return ExtType(EXT_NDARRAY_BF16, payload)


def _unpack_ndarray_bf16(payload: bytes) -> np.ndarray:
    shape, raw = unpackb(payload)
    # the f32 materialization is freshly allocated either way — always
    # writable, never a counted buffer copy
    return _view_f32(raw, shape)


def _make_default(bf16_floats: bool):
    def _default(obj: Any):
        arr = _host_leaf(obj)
        if isinstance(arr, ExtType):
            return arr
        if arr is not None:
            if bf16_floats and arr.dtype == np.float32:
                return _pack_ndarray_bf16(arr)
            return _pack_ndarray(arr)
        cls = type(obj)
        # exact-class lookup only: silently serializing a subclass through
        # its base would drop overridden fields and downcast on the far side
        type_name = _CLS_NAMES.get(cls)
        if type_name is not None:
            _, bufferize, _ = _REGISTRY[type_name]
            # Type name packed as its own leading msgpack object (not inside
            # one array) so deserialization can read it without decoding the
            # payload.
            inner = packb(type_name) + packb(bufferize(obj), default=_default)
            return ExtType(EXT_OBJECT, inner)
        if isinstance(obj, set):
            return sorted(obj)
        if isinstance(obj, tuple):
            return list(obj)
        raise TypeError(f"pygrid_tpu_torch.serde: cannot serialize {cls!r}")

    return _default


_default = _make_default(bf16_floats=False)


def _make_ext_hook(copy: bool, device=None):
    def _hook(code: int, payload: bytes):
        if code == EXT_NDARRAY:
            return _unpack_ndarray(payload, copy)
        if code == EXT_NDARRAY_BF16:
            return _unpack_ndarray_bf16(payload)
        if code == EXT_OBJECT:
            reader = Reader(payload, ext_hook=_hook)
            # Read the leading type name alone, register its class (may
            # import the defining module), then decode the payload exactly
            # once.
            type_name = reader.read()
            _ensure_registered(type_name)
            entry = _REGISTRY.get(type_name)
            if entry is None:
                raise TypeError(
                    f"pygrid_tpu_torch.serde: unknown wire type {type_name!r}"
                )
            data = reader.read()
            _, _, unbufferize = entry
            if type_name in _TAKES_DEVICE:
                return unbufferize(data, device=device)
            return unbufferize(data)
        return ExtType(code, payload)

    return _hook




#: Modules that register wire types as an import side effect. Deserialization
#: must work in processes that only imported ``pygrid_tpu_torch.serde`` (e.g.
#: a thin client), so unknown type names trigger a lazy import sweep of these.
_LAZY_MODULES = (
    "pygrid_tpu_torch.plans",
    "pygrid_tpu_torch.smpc",
    "pygrid_tpu_torch.runtime",
)


def _ensure_registered(type_name: str) -> None:
    if type_name in _REGISTRY:
        return
    import importlib

    for mod in _LAZY_MODULES:
        try:
            importlib.import_module(mod)
        except ImportError:
            continue
        if type_name in _REGISTRY:
            return


def serialize(obj: Any, *, bf16_floats: bool = False) -> bytes:
    """Serialize ``obj`` (tensors, registered objects, plain structures).

    ``bf16_floats=True`` sends float32 arrays as bfloat16 bit patterns —
    half the wire bytes, decoded back to float32 by any receiver."""
    default = _make_default(bf16_floats) if bf16_floats else _default
    return packb(obj, default=default)


def deserialize(
    blob: bytes | bytearray | memoryview, *, copy: bool = False, device="cuda"
) -> Any:
    """Decode a wire blob.

    Tensors come back as host numpy arrays; ``device`` (default
    ``"cuda"``) is where registered objects that hold torch tensors put
    them (an ``AdditiveSharingTensor``'s shares), and it is resolved only
    when the blob holds one: without a GPU such a blob needs
    ``device="cpu"``.

    ``copy=False`` (the default) returns tensors as READ-ONLY views: a
    plain dense State decodes with zero tensor-buffer copies — each
    array aliases ``blob`` directly (the array's ``base`` keeps it
    alive); other envelopes alias the ext payload bytes the msgpack
    parser produced. Callers that mutate decoded tensors in place opt
    into ``copy=True`` for writable arrays (the v1 behavior)."""
    if not copy:
        try:
            state = _cursor_state_object(blob)
        except Exception:  # noqa: BLE001 — malformed → general parse raises
            state = None
        if state is not None:
            return state
    return unpackb(blob, ext_hook=_make_ext_hook(copy, device))


class RawTensor:
    """A tensor still in wire form: dtype tag, shape, and the raw payload
    buffer — no array materialization. The FL report fold accumulates
    straight from these (``native.accum_f32``/``accum_bf16``), skipping
    the frombuffer/astype copies of a full decode."""

    __slots__ = ("kind", "shape", "raw")

    def __init__(self, kind: str, shape: tuple, raw: bytes) -> None:
        self.kind = kind          # numpy dtype str, or "bf16"
        self.shape = shape
        self.raw = raw

    @property
    def nelems(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n

    def itemsize(self) -> int:
        return 2 if self.kind == "bf16" else np.dtype(self.kind).itemsize


class _NotPlainState(Exception):
    pass


def _raw_ext_hook(code: int, payload: bytes):
    if code == EXT_NDARRAY:
        dtype_str, shape, raw = unpackb(payload)
        return RawTensor(dtype_str, tuple(shape), raw)
    if code == EXT_NDARRAY_BF16:
        shape, raw = unpackb(payload)
        return RawTensor("bf16", tuple(shape), raw)
    if code == EXT_OBJECT:
        reader = Reader(payload, ext_hook=_raw_ext_hook)
        type_name = reader.read()
        if type_name not in ("pygrid.State", "pygrid.PlaceHolder"):
            raise _NotPlainState(type_name)
        return {"__wire_type": type_name, "data": reader.read()}
    raise _NotPlainState(f"ext code {code}")


def _cursor_placeholders(blob) -> list[tuple[dict, str, tuple, Any]] | None:
    """Shared zero-copy walk of a dense-State wire blob: per placeholder,
    ``(ph_data, kind, shape, raw)`` where ``raw`` is a memoryview slice of
    the caller's buffer (which must stay alive) and ``kind`` is a numpy
    dtype str or ``"bf16"``. None when the blob is not a plain dense
    State (the callers then fall back to the general parse)."""
    top = Reader(blob, zero_copy=True).read()
    out = []
    for ph_code, ph_payload in _expect_obj(top, "pygrid.State")[
        "placeholders"
    ]:
        if ph_code != EXT_OBJECT:
            return None
        ph = Reader(ph_payload, zero_copy=True)
        if ph.read() != "pygrid.PlaceHolder":
            return None
        ph_data = ph.read()
        tensor = ph_data.get("tensor")
        if not isinstance(tensor, tuple):
            return None
        code, payload = tensor
        cur = Reader(payload, zero_copy=True)
        if code == EXT_NDARRAY:
            dtype_str, shape, raw = cur.read()
        elif code == EXT_NDARRAY_BF16:
            dtype_str = "bf16"
            shape, raw = cur.read()
        else:
            return None
        if not isinstance(raw, memoryview):
            return None
        out.append((ph_data, dtype_str, tuple(shape), raw))
    return out


def _cursor_state(blob) -> list[RawTensor] | None:
    """Zero-copy walk of a dense-State wire blob: RawTensor.raw values are
    memoryview slices of the caller's buffer (which must stay alive)."""
    walked = _cursor_placeholders(blob)
    if walked is None:
        return None
    return [
        RawTensor(kind, shape, raw) for _, kind, shape, raw in walked
    ]


def _cursor_state_object(blob):
    """Zero-copy decode of a plain dense State: ndarray leaves are
    read-only views over ``blob`` itself (no msgpack ext-payload copy,
    no buffer copy). Returns None for anything that isn't such a State;
    raises on inconsistent headers so the caller falls back to the
    general parser, which owns error reporting."""
    walked = _cursor_placeholders(blob)
    if walked is None:
        return None
    from pygrid_tpu_torch.plans.placeholder import PlaceHolder
    from pygrid_tpu_torch.plans.state import State

    placeholders = []
    for ph_data, kind, shape, raw in walked:
        if kind == "bf16":
            arr = _view_f32(raw, shape)
        else:
            arr = np.frombuffer(raw, dtype=np.dtype(kind))
            arr.flags.writeable = False  # raw may view a writable buffer
            arr = arr.reshape(shape)
        placeholders.append(
            PlaceHolder(
                tensor=arr,
                id=ph_data.get("id"),
                tags=set(ph_data.get("tags") or ()),
                description=str(ph_data.get("description") or ""),
            )
        )
    return State(placeholders)


def _expect_obj(token, type_name: str) -> dict:
    if not (isinstance(token, tuple) and token[0] == EXT_OBJECT):
        raise ValueError("not a wire object")
    cur = Reader(token[1], zero_copy=True)
    if cur.read() != type_name:
        raise ValueError(f"not a {type_name}")
    data = cur.read()
    if not isinstance(data, dict):
        raise ValueError("malformed wire object")
    return data


def state_raw_tensors(blob: bytes | bytearray) -> list[RawTensor] | None:
    """Parse a State wire blob into its tensors' raw wire buffers WITHOUT
    materializing arrays — the report-ingest fast path. Returns None when
    the blob is not a plain dense State (sparse envelopes, wrapped
    tensors, other objects, malformed bytes): callers then take the full
    :func:`deserialize` door, which owns error reporting.

    The fast path is a hand-rolled zero-copy cursor (tensor buffers are
    memoryview slices of ``blob``); the general ext-hook parse is the
    fallback for envelopes the cursor doesn't recognize."""
    try:
        out = _cursor_state(blob)
        if out is not None:
            for rt in out:
                if len(rt.raw) != rt.nelems * rt.itemsize():
                    return None  # inconsistent header → full decode raises
            return out
    except Exception:  # noqa: BLE001 — fall through to the general parse
        pass
    try:
        obj = unpackb(blob, ext_hook=_raw_ext_hook)
    except Exception:  # noqa: BLE001 — malformed → full decode path
        return None
    try:
        if not (
            isinstance(obj, dict) and obj.get("__wire_type") == "pygrid.State"
        ):
            return None
        out: list[RawTensor] = []
        for ph in obj["data"].get("placeholders", ()):
            if not (
                isinstance(ph, dict)
                and ph.get("__wire_type") == "pygrid.PlaceHolder"
            ):
                return None
            tensor = ph["data"].get("tensor")
            if not isinstance(tensor, RawTensor):
                return None
            if len(tensor.raw) != tensor.nelems * tensor.itemsize():
                return None  # inconsistent header → full decode raises
            out.append(tensor)
        return out
    except Exception:  # noqa: BLE001 — hostile headers → full decode path
        return None


def to_hex(obj: Any) -> str:
    """Hex-string wrapper used by the host-training JSON payloads (parity with
    reference fl_events.py:27-62 which unhexlifies model/plan fields)."""
    return binascii.hexlify(serialize(obj)).decode()


def from_hex(hexstr: str) -> Any:
    return deserialize(binascii.unhexlify(hexstr))


# ── wire v2: negotiated binary frames + optional per-frame compression ───────
#
# Negotiation rides the RFC 6455 subprotocol field — no extra round trip,
# and a peer that never heard of it (v1 client, reference syft.js client)
# simply doesn't send the header and keeps the hex/base64-in-JSON framing.
# On a negotiated connection every BINARY frame starts with one codec tag
# byte; TEXT (JSON) frames are untouched in either direction, so the
# legacy event surface stays live on the same socket.

#: the subprotocol token; a negotiated codec appends ``+zstd`` / ``+zlib``
WS_SUBPROTOCOL_V2 = "pygrid.wire.v2"
#: the trace-capable variant: frames MAY carry the 0x80 trace-header tag
#: bit. A separate token because the bit is a frame-format extension —
#: a peer that negotiated plain v2 must never receive it (its decoder
#: predates the flag and would reject the tag byte).
WS_SUBPROTOCOL_V2_TRACE = WS_SUBPROTOCOL_V2 + ".trace"

FRAME_RAW = 0x00
FRAME_ZLIB = 0x01
FRAME_ZSTD = 0x02
_CODEC_TAGS = {"zlib": FRAME_ZLIB, "zstd": FRAME_ZSTD}

#: tag high bit: a trace-context header (16-byte trace id + 8-byte span
#: id) sits between the tag byte and the payload. Orthogonal to the
#: codec in the low bits; a frame without the bit is byte-identical to
#: the PR-1 format, so untraced peers interoperate unchanged.
FRAME_TRACE_FLAG = 0x80
TRACE_HEADER_BYTES = 24

try:  # optional dependency — the container may not ship it
    import zstandard as _zstd
except ImportError:
    _zstd = None

#: frames below this never compress: the tag byte + codec header would
#: cost more than they save, and serde payloads this small are control
#: messages, not tensors
MIN_COMPRESS_BYTES = 512

#: decompression output cap — matches the websocket max frame size, so a
#: hostile tiny frame cannot expand into gigabytes of node RSS
MAX_DECOMPRESSED_BYTES = 1 << 28


def available_codecs() -> tuple[str, ...]:
    """Codecs this build can actually run, preference-ordered. zstd only
    when the ``zstandard`` module is importable; zlib is stdlib."""
    return ("zstd", "zlib") if _zstd is not None else ("zlib",)


def offered_subprotocols(codec: str | None = "auto") -> list[str]:
    """Client-side offer list, preference-ordered: trace-capable variants
    first (compressed before plain), then the same ladder without trace,
    plain v2 last — so a codec-less or trace-less server still negotiates
    the best framing it knows. ``codec=None`` offers no compression;
    ``"auto"`` offers everything this build supports."""
    if codec == "auto":
        with_codec = [f"+{c}" for c in available_codecs()]
    elif codec:
        if codec not in available_codecs():
            raise ValueError(
                f"codec {codec!r} not available (have {available_codecs()})"
            )
        with_codec = [f"+{codec}"]
    else:
        with_codec = []
    suffixes = with_codec + [""]
    return [f"{WS_SUBPROTOCOL_V2_TRACE}{s}" for s in suffixes] + [
        f"{WS_SUBPROTOCOL_V2}{s}" for s in suffixes
    ]


def subprotocol_codec(proto: str | None) -> tuple[bool, str | None]:
    """``(v2_negotiated, codec)`` from the handshake's selected
    subprotocol (trace-capable variants included). Anything unrecognized
    — including a ``+codec`` suffix this build can't run — degrades to
    not-negotiated, never an error: the legacy framing always works."""
    if not proto:
        return False, None
    proto = str(proto)
    for base in (WS_SUBPROTOCOL_V2_TRACE, WS_SUBPROTOCOL_V2):
        if proto == base:
            return True, None
        if proto.startswith(base + "+"):
            codec = proto[len(base) + 1:]
            if codec in available_codecs():
                return True, codec
            return False, None
    return False, None


def subprotocol_traced(proto: str | None) -> bool:
    """Whether the negotiated subprotocol permits the 0x80 trace-header
    tag bit on binary frames (both directions)."""
    if not proto or not str(proto).startswith(WS_SUBPROTOCOL_V2_TRACE):
        return False
    return subprotocol_codec(proto)[0]


def encode_frame(
    payload: bytes, codec: str | None = None, trace: bytes | None = None
) -> bytes:
    """Wrap a serde payload for a v2 connection: one codec tag byte, then
    the (possibly compressed) payload. Compression is per-frame and only
    kept when it actually wins — high-entropy float payloads commonly
    don't shrink, and shipping them raw costs one tag byte.

    ``trace``: an optional :data:`TRACE_HEADER_BYTES` trace-context
    header (``telemetry.trace.to_bytes``) carried between the tag byte
    and the payload, flagged by the tag's high bit."""
    head = b""
    flag = 0
    if trace is not None:
        if len(trace) != TRACE_HEADER_BYTES:
            raise ValueError(
                f"trace header must be {TRACE_HEADER_BYTES} bytes"
            )
        head = bytes(trace)
        flag = FRAME_TRACE_FLAG
    if codec and len(payload) >= MIN_COMPRESS_BYTES:
        if codec == "zstd" and _zstd is not None:
            packed = _zstd.ZstdCompressor(level=3).compress(bytes(payload))
            tag = FRAME_ZSTD
        elif codec == "zlib":
            packed = zlib.compress(bytes(payload), level=1)
            tag = FRAME_ZLIB
        else:
            raise ValueError(f"unknown frame codec {codec!r}")
        if len(packed) < len(payload):
            return bytes((tag | flag,)) + head + packed
    return bytes((FRAME_RAW | flag,)) + head + bytes(payload)


def decode_frame(frame: bytes | bytearray | memoryview) -> Any:
    """Unwrap a v2 binary frame → the serde payload (any trace header is
    skipped; use :func:`decode_frame_traced` to keep it)."""
    return decode_frame_traced(frame)[0]


def decode_frame_traced(
    frame: bytes | bytearray | memoryview,
) -> tuple[Any, bytes | None]:
    """Unwrap a v2 binary frame → ``(payload, trace_header_or_None)``.
    Raw frames return a zero-copy memoryview into ``frame``; compressed
    frames return fresh bytes, output-capped so a hostile frame can't
    balloon node memory."""
    view = memoryview(frame)
    if len(view) < 1:
        raise ValueError("empty wire-v2 frame")
    tag = view[0]
    trace = None
    body = view[1:]
    if tag & FRAME_TRACE_FLAG:
        tag &= ~FRAME_TRACE_FLAG
        if len(view) < 1 + TRACE_HEADER_BYTES:
            raise ValueError("wire-v2 frame truncates its trace header")
        trace = bytes(view[1 : 1 + TRACE_HEADER_BYTES])
        body = view[1 + TRACE_HEADER_BYTES :]
    if tag == FRAME_RAW:
        return body, trace
    if tag == FRAME_ZLIB:
        d = zlib.decompressobj()
        try:
            out = d.decompress(bytes(body), MAX_DECOMPRESSED_BYTES)
        except zlib.error as err:  # peer-supplied bytes → typed error
            raise ValueError(f"bad zlib frame: {err}") from err
        if len(out) >= MAX_DECOMPRESSED_BYTES:
            raise ValueError("wire-v2 frame decompresses past the size cap")
        if not d.eof or d.unused_data:
            # a truncated-but-valid prefix decompresses without raising —
            # partial payload must be a typed error, not garbage msgpack
            raise ValueError("bad zlib frame: truncated or trailing bytes")
        return out, trace
    if tag == FRAME_ZSTD:
        if _zstd is None:
            raise ValueError("zstd frame received but zstandard not installed")
        try:
            return (
                _zstd.ZstdDecompressor().decompress(
                    bytes(body), max_output_size=MAX_DECOMPRESSED_BYTES
                ),
                trace,
            )
        except _zstd.ZstdError as err:
            raise ValueError(f"bad zstd frame: {err}") from err
    raise ValueError(f"unknown wire-v2 frame tag {tag:#x}")
