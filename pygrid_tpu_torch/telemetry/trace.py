"""Distributed-trace context and its wire encodings.

One FL cycle touches four processes (client → node ws → cycle manager →
back), and the point of tracing is that every span they record carries
the SAME ``trace_id`` so the round stitches into one timeline. The
context rides three wire shapes:

- **wire-v2 binary frames**: a 24-byte header (16-byte trace id +
  8-byte span id) between the frame tag byte and the payload, flagged
  by the tag's high bit (``serde.wire.FRAME_TRACE_FLAG``);
- **legacy JSON framing**: a ``trace`` field on the message envelope,
  compact text form ``"<32 hex trace_id>-<16 hex span_id>"``;
- **HTTP**: the ``X-PyGrid-Trace`` request header, same text form.

A server receiving no trace context **synthesizes a root trace** — a
legacy client's cycle is still fully traced node-side, it just cannot
contribute client spans.

Context lives in a :mod:`contextvars` variable, so it propagates through
``await`` and stays isolated between the node's executor threads.

The port's copy of :mod:`pygrid_tpu.telemetry.trace`, with the port's imports.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
import time
from typing import Iterator, NamedTuple

from pygrid_tpu_torch.telemetry import bus

#: HTTP request header carrying the compact text form
TRACE_HEADER = "X-PyGrid-Trace"

_HEADER_RE = re.compile(r"^([0-9a-f]{32})-([0-9a-f]{16})$")


class TraceContext(NamedTuple):
    trace_id: str  # 32 lowercase hex chars (16 bytes)
    span_id: str   # 16 lowercase hex chars (8 bytes)


_current: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "pygrid_trace", default=None
)


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def current() -> TraceContext | None:
    return _current.get()


# ── wire encodings ──────────────────────────────────────────────────────


def header(ctx: TraceContext | None = None) -> str | None:
    """Compact text form for JSON fields / HTTP headers."""
    ctx = ctx or _current.get()
    if ctx is None:
        return None
    return f"{ctx.trace_id}-{ctx.span_id}"


def parse_header(value: object) -> TraceContext | None:
    """Strict parse of the compact text form; anything malformed (wrong
    length, non-hex, wrong type) is None — peer-supplied bytes must not
    raise out of the framing layer."""
    if not isinstance(value, str):
        return None
    m = _HEADER_RE.match(value)
    if m is None:
        return None
    return TraceContext(m.group(1), m.group(2))


def to_bytes(ctx: TraceContext | None = None) -> bytes | None:
    """The 24-byte wire-v2 frame header form."""
    ctx = ctx or _current.get()
    if ctx is None:
        return None
    return bytes.fromhex(ctx.trace_id) + bytes.fromhex(ctx.span_id)


def from_bytes(raw: bytes | bytearray | memoryview | None) -> TraceContext | None:
    if raw is None:
        return None
    raw = bytes(raw)
    if len(raw) != 24:
        return None
    return TraceContext(raw[:16].hex(), raw[16:].hex())


# ── context management ──────────────────────────────────────────────────


@contextlib.contextmanager
def use(ctx: TraceContext) -> Iterator[TraceContext]:
    """Activate an explicit context (e.g. an FLJob's cycle-long root) for
    the duration of the block."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


@contextlib.contextmanager
def serve(incoming: TraceContext | None = None) -> Iterator[TraceContext]:
    """Server-side adoption: a child span of ``incoming`` when the peer
    sent context, a child of the already-active context when nested, and
    a fresh synthesized root otherwise (the legacy-client path)."""
    parent = incoming if incoming is not None else _current.get()
    ctx = TraceContext(
        parent.trace_id if parent is not None else new_trace_id(),
        new_span_id(),
    )
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


@contextlib.contextmanager
def span(name: str, **fields: object) -> Iterator[TraceContext]:
    """Record a named span: activates a child context for the block and
    appends one ``span`` event (trace/span/parent ids + duration) to the
    bus at exit."""
    parent = _current.get()
    ctx = TraceContext(
        parent.trace_id if parent is not None else new_trace_id(),
        new_span_id(),
    )
    token = _current.set(ctx)
    t0 = time.monotonic()
    try:
        yield ctx
    finally:
        _current.reset(token)
        bus.record(
            "span",
            name=name,
            trace_id=ctx.trace_id,
            span_id=ctx.span_id,
            parent_id=parent.span_id if parent is not None else None,
            duration_s=time.monotonic() - t0,
            **fields,
        )
