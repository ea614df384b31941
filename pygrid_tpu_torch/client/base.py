"""Synchronous WebSocket grid client.

The transport under every SDK client: JSON request/response with request_id
correlation plus raw binary frames (the two frame kinds the Node's
``route_requests`` handles — reference ``events/__init__.py:61-107``).
Built on the in-repo blocking transport (``client.ws_transport`` — no
asyncio, no background reader threads; mirroring the reference's blocking
syft clients while avoiding per-message thread handoffs on busy hosts).
The port's copy of :mod:`pygrid_tpu.client.base`.
"""

from __future__ import annotations

import json
import re
import threading
import uuid
from typing import Any

from pygrid_tpu_torch.client.ws_transport import RawWSClient
from pygrid_tpu_torch.telemetry import trace
from pygrid_tpu_torch.utils.codes import MSG_FIELD

#: bytes a JSON string cannot carry verbatim: the two escape characters,
#: controls, and anything non-ASCII (send_json_spliced's safety gate)
_SPLICE_UNSAFE = re.compile(rb'["\\\x00-\x1f\x7f-\xff]')


class GridWSClient:
    def __init__(
        self,
        address: str,
        timeout: float = 30.0,
        offer_wire_v2: bool = False,
        codec: str | None = None,
    ) -> None:
        self.address = address.rstrip("/")
        ws_url = self.address
        for scheme, ws_scheme in (("https", "wss"), ("http", "ws")):
            if ws_url.startswith(scheme + "://"):
                ws_url = ws_scheme + "://" + ws_url[len(scheme) + 3:]
                break
        self.ws_url = ws_url
        self.timeout = timeout
        #: offer the wire-v2 subprotocol (and ``codec``: None / "auto" /
        #: a codec name) at connect; whether the server took it is
        #: ``self.wire_v2`` / ``self.wire_codec`` after the handshake
        self.offer_wire_v2 = offer_wire_v2
        self.codec = codec
        self.wire_v2 = False
        self.wire_codec: str | None = None
        #: whether the server took the ``.trace`` subprotocol variant —
        #: frame trace headers are sent only then (a plain-v2 server's
        #: decoder predates the tag bit)
        self.wire_trace = False
        self._ws = None
        # reentrant: connect() locks on its own (callers may probe
        # negotiation state before any request) and is also reached from
        # inside already-locked request paths
        self._lock = threading.RLock()
        self._req_prefix = uuid.uuid4().hex[:8]
        self._req_seq = 0

    # ── connection ──────────────────────────────────────────────────────────

    def connect(self) -> "GridWSClient":
        with self._lock:
            return self._connect_locked()

    def _connect_locked(self) -> "GridWSClient":
        if self._ws is None:
            # no permessage-deflate: grid payloads are serde/base64 bytes
            # (high entropy), where zlib costs ~40x the loopback wire time
            # per MB and saves nothing — measured 128 ms vs 3.4 ms for a
            # 1.66MB report frame. (Wire-v2 frame compression is per-frame
            # and opt-in, kept only when it wins — a different trade.)
            # Frames mask through the native XOR kernel (the analog of the
            # reference's masking patch, util.py:5-24).
            offers: tuple[str, ...] = ()
            if self.offer_wire_v2:
                from pygrid_tpu_torch.serde import offered_subprotocols

                offers = tuple(offered_subprotocols(self.codec))
            self._ws = RawWSClient(
                self.ws_url,
                open_timeout=self.timeout,
                max_size=2**28,
                subprotocols=offers,
            )
            from pygrid_tpu_torch.serde import subprotocol_codec, subprotocol_traced

            self.wire_v2, self.wire_codec = subprotocol_codec(
                self._ws.subprotocol
            )
            self.wire_trace = subprotocol_traced(self._ws.subprotocol)
        return self

    def close(self) -> None:
        # under the lock: close() racing an in-flight _request must not
        # null the socket mid-round-trip (gridlint GL202)
        with self._lock:
            if self._ws is not None:
                self._ws.close()
                self._ws = None

    def __enter__(self) -> "GridWSClient":
        return self.connect()

    def __exit__(self, *exc) -> None:
        self.close()

    # ── request/response ────────────────────────────────────────────────────

    def _request(
        self,
        msg_type: str,
        data: Any,
        top_level: dict,
        encode: Any,
        decode: Any,
        want_bytes: bool,
    ) -> dict:
        """One event round-trip: frame, send, then read frames of the
        matching kind until the request_id correlates (frames of the other
        kind on the same socket belong to other traffic)."""
        # the lock covers connect + sequence + round trip: _ws and
        # _req_seq are shared across calling threads
        with self._lock:
            self.connect()
            # unique per connection is all correlation needs (responses
            # ride the same socket) — a counter beats per-request urandom
            self._req_seq += 1
            request_id = f"{self._req_prefix}-{self._req_seq}"
            # every request is a client span: the envelope's `trace`
            # field (and, for wire-v2, the frame header written by the
            # encoder reading trace.current()) carries the context so
            # node-side spans stitch into the same trace
            with trace.span("client.request", event_type=msg_type) as tctx:
                message: dict[str, Any] = {
                    MSG_FIELD.TYPE: msg_type,
                    MSG_FIELD.REQUEST_ID: request_id,
                    "trace": trace.header(tctx),
                }
                if data is not None:
                    message[MSG_FIELD.DATA] = data
                message.update(top_level)
                try:
                    self._ws.send(encode(message))
                    return self._recv_correlated(
                        request_id, decode, want_bytes
                    )
                except (ConnectionError, TimeoutError, OSError):
                    self._drop_connection()
                    raise

    def _recv_correlated(
        self, request_id: str, decode: Any, want_bytes: bool
    ) -> dict:
        """Read frames of the matching kind until the request_id
        correlates (frames of the other kind belong to other traffic).
        Caller holds the lock and owns connection-drop on error."""
        while True:
            frame = self._ws.recv(timeout=self.timeout)
            if isinstance(frame, bytes) is not want_bytes:
                continue  # stray frame of the other kind: not ours
            response = decode(frame)
            if isinstance(response, dict) and response.get(
                MSG_FIELD.REQUEST_ID
            ) in (None, request_id):
                return response

    def _drop_connection(self) -> None:
        """Under the lock (every caller is a locked round-trip path): a
        transport error mid-round-trip leaves the stream position
        unknown (e.g. a recv timeout after part of a frame was consumed)
        — never reuse the socket; the next call reconnects."""
        if self._ws is not None:
            try:
                self._ws.close()
            except OSError:
                pass
            self._ws = None

    def send_json(self, msg_type: str, data: Any = None, **top_level) -> dict:
        """One JSON round-trip; request_id correlates the response."""
        return self._request(
            msg_type, data, top_level, json.dumps, json.loads, want_bytes=False
        )

    def send_json_spliced(
        self, msg_type: str, data: dict, raw_key: str, raw_value: bytes | str
    ) -> dict:
        """JSON round-trip with one large escape-free ASCII field spliced
        into ``data`` after serialization — identical wire bytes to
        :meth:`send_json`, but ``json.dumps`` never escape-scans the
        megabyte payload (base64 contains no escapable characters), and a
        ``bytes`` value (e.g. straight from ``b64encode``) skips the
        str-decode/utf-8-encode round trip entirely. The FL report path
        sends ~1.7 MB frames per cycle through this."""
        payload = (
            raw_value if isinstance(raw_value, bytes) else raw_value.encode()
        )
        # the splice bypasses json.dumps' escaping, so the framing
        # invariant is only as strong as this check: any byte that JSON
        # would escape (quote, backslash, control, non-ASCII) must be
        # rejected, not silently spliced into a meaning-altering frame —
        # for the key as much as the value
        if _SPLICE_UNSAFE.search(payload) or _SPLICE_UNSAFE.search(
            raw_key.encode()
        ):
            raise ValueError(
                "send_json_spliced key/value must be escape-free ASCII "
                "(base64-alphabet); got a byte JSON would escape"
            )
        with self._lock:
            self.connect()
            self._req_seq += 1
            request_id = f"{self._req_prefix}-{self._req_seq}"
            with trace.span("client.request", event_type=msg_type) as tctx:
                head = json.dumps(
                    {
                        MSG_FIELD.TYPE: msg_type,
                        MSG_FIELD.REQUEST_ID: request_id,
                        "trace": trace.header(tctx),
                        MSG_FIELD.DATA: data,
                    }
                )
                if not head.endswith("}}"):
                    raise ValueError("unexpected JSON head shape for splice")
                sep = ", " if data else ""
                frame = b"".join(
                    (head[:-2].encode(), f'{sep}"{raw_key}": "'.encode(),
                     payload, b'"}}')
                )
                try:
                    self._ws.send_text_bytes(frame)
                    return self._recv_correlated(
                        request_id, json.loads, want_bytes=False
                    )
                except (ConnectionError, TimeoutError, OSError):
                    self._drop_connection()
                    raise

    def send_msg_binary(self, msg_type: str, data: Any = None, **top_level) -> dict:
        """One msgpack-framed event round-trip — the binary twin of
        :meth:`send_json`. Payload bytes (e.g. FL diffs) travel raw: no
        base64 inflation, no megabyte JSON parse on either side. On a
        wire-v2 connection frames carry the codec tag (and compress when
        negotiated + worthwhile); otherwise bare msgpack, which any node
        of this framework accepts."""
        from pygrid_tpu_torch.serde import (
            decode_frame,
            deserialize,
            encode_frame,
            serialize,
        )

        # framing is checked at call time (under _request's lock, after
        # connect) — negotiation state doesn't exist before the handshake.
        # encode runs inside _request's client span, so trace.current()
        # is the span to stamp into the wire-v2 frame header.
        def encode(msg: Any) -> bytes:
            blob = serialize(msg)
            if self.wire_v2:
                return encode_frame(
                    blob, self.wire_codec,
                    trace=trace.to_bytes() if self.wire_trace else None,
                )
            return blob

        def decode(frame: bytes) -> Any:
            return deserialize(decode_frame(frame) if self.wire_v2 else frame)

        return self._request(
            msg_type, data, top_level, encode, decode, want_bytes=True
        )

    def send_binary(self, blob: bytes) -> bytes:
        """One binary round-trip (syft wire messages)."""
        with self._lock:
            self.connect()
            try:
                if self.wire_v2:
                    from pygrid_tpu_torch.serde import decode_frame, encode_frame

                    with trace.span("client.request", event_type="syft-binary") as tctx:
                        self._ws.send(
                            encode_frame(
                                blob, self.wire_codec,
                                trace=(
                                    trace.to_bytes(tctx)
                                    if self.wire_trace
                                    else None
                                ),
                            )
                        )
                else:
                    self._ws.send(blob)
                while True:
                    frame = self._ws.recv(timeout=self.timeout)
                    if isinstance(frame, bytes):
                        if self.wire_v2:
                            return bytes(decode_frame(frame))
                        return frame
            except (ConnectionError, TimeoutError, OSError):
                self._drop_connection()
                raise
