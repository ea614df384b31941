"""Minimal blocking WebSocket client transport (RFC 6455).

Why not the ``websockets`` package: its sync client spawns a background
reader thread per connection and hands every frame across a thread
boundary. A grid client does strict request→response round trips, so the
handoff buys nothing — and on a single-core host running many workers
(the protocol bench, edge simulators) the per-message context switches
dominate the wire time. This transport reads on the calling thread:
send → recv, no events, no queues, no extra threads.

Scope: client side only (client frames masked via the native XOR kernel),
text + binary + fragmented messages, ping/pong/close handling. TLS via
``ssl://``-style ``wss`` URLs. The server side is
:mod:`pygrid_tpu_torch.web.websocket` (reference analog: gevent-websocket
+ wsaccel, apps/node/pyproject.toml:31).

The port's copy of :mod:`pygrid_tpu.client.ws_transport`, masking through
the port's :mod:`pygrid_tpu_torch.native`.
"""

from __future__ import annotations

import base64
import hashlib
import os
import random
import socket
import ssl as ssl_module
import struct
import time
from urllib.parse import urlparse

from pygrid_tpu_torch.native import xor_mask_inplace

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = (
    0x0, 0x1, 0x2, 0x8, 0x9, 0xA,
)


class WSConnectionClosed(ConnectionError):
    """The server closed the websocket (close frame or EOF)."""


#: Fault-injection shim (a storm harness): when set, called as
#: ``CHAOS_HOOK(direction, nbytes)`` with direction ``"send"`` before a
#: data frame hits the socket and ``"recv"`` at recv() entry. The hook
#: may sleep (slow link) or raise :class:`WSConnectionClosed` (cut
#: link — a ConnectionError, so every existing close/retry path applies
#: unchanged). None in production; never wrap control frames, which
#: would distort close handshakes.
CHAOS_HOOK = None


class WSTimeout(TimeoutError):
    """No complete message arrived within the recv timeout."""


class KeepAliveHTTP:
    """Minimal keep-alive HTTP/1.1 GET client over ``http.client``.

    ``requests`` pays ~1.5 ms of per-call bookkeeping (session hooks,
    cookie jars, adapter dispatch) — measured 2.2 ms vs 0.5 ms for the
    same loopback GET. Checkpoint downloads happen once per worker per
    cycle, so that overhead is protocol-plane throughput. Reconnects once
    on a dropped keep-alive connection; not thread-safe (one per client)."""

    def __init__(self, base_url: str, timeout: float = 60.0) -> None:
        import http.client

        parsed = urlparse(base_url)
        self._https = parsed.scheme == "https"
        self._host = parsed.hostname or "localhost"
        self._port = parsed.port or (443 if self._https else 80)
        self._timeout = timeout
        self._http = http.client
        self._conn = None
        #: lower-cased headers of the most recent response — how callers
        #: detect opt-in encodings the server actually applied (e.g. the
        #: wire-v2 frame envelope on compressed checkpoint downloads)
        self.last_headers: dict[str, str] = {}

    def _connect(self):
        if self._https:
            return self._http.HTTPSConnection(
                self._host, self._port, timeout=self._timeout
            )
        return self._http.HTTPConnection(
            self._host, self._port, timeout=self._timeout
        )

    def get(
        self,
        path: str,
        params: dict | None = None,
        headers: dict | None = None,
    ) -> tuple[int, bytes]:
        from urllib.parse import urlencode

        if params:
            path = f"{path}?{urlencode(params)}"
        for attempt in (0, 1):
            if self._conn is None:
                self._conn = self._connect()
            try:
                self._conn.request("GET", path, headers=headers or {})
                resp = self._conn.getresponse()
                body = resp.read()
                self.last_headers = {
                    k.lower(): v for k, v in resp.getheaders()
                }
                return resp.status, body
            except (OSError, self._http.HTTPException):
                # stale keep-alive (server closed between cycles) — one
                # fresh-connection retry, then surface the error
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None
                if attempt:
                    raise
        raise ConnectionError("unreachable")  # pragma: no cover

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None


class RawWSClient:
    """One blocking websocket connection; not thread-safe (callers hold
    their own lock — ``GridWSClient`` serializes round trips already)."""

    def __init__(
        self,
        url: str,
        open_timeout: float = 30.0,
        max_size: int = 2 ** 28,
        subprotocols: list[str] | tuple[str, ...] = (),
    ) -> None:
        parsed = urlparse(url)
        if parsed.scheme not in ("ws", "wss"):
            raise ValueError(f"not a ws:// url: {url}")
        self.host = parsed.hostname or "localhost"
        self.port = parsed.port or (443 if parsed.scheme == "wss" else 80)
        self.path = parsed.path or "/"
        if parsed.query:
            self.path += "?" + parsed.query
        self.max_size = max_size
        self.subprotocols = tuple(subprotocols)
        #: the server-selected subprotocol (RFC 6455 §1.9) — None when the
        #: server ignored the offer (a pre-subprotocol node): the caller's
        #: cue to stay on legacy framing
        self.subprotocol: str | None = None
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=open_timeout
        )
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if parsed.scheme == "wss":
            ctx = ssl_module.create_default_context()
            self._sock = ctx.wrap_socket(self._sock, server_hostname=self.host)
        self._rfile = self._sock.makefile("rb", buffering=256 * 1024)
        self._deadline: float | None = None  # set per recv() call
        self._handshake(open_timeout)

    # ── handshake ────────────────────────────────────────────────────────────

    def _handshake(self, timeout: float) -> None:
        key = base64.b64encode(os.urandom(16)).decode()
        proto_header = (
            f"Sec-WebSocket-Protocol: {', '.join(self.subprotocols)}\r\n"
            if self.subprotocols
            else ""
        )
        request = (
            f"GET {self.path} HTTP/1.1\r\n"
            f"Host: {self.host}:{self.port}\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            f"{proto_header}"
            "Sec-WebSocket-Version: 13\r\n"
            "\r\n"
        )
        self._sock.sendall(request.encode())
        status = self._rfile.readline(8192)
        if b" 101 " not in status:
            raise ConnectionError(f"websocket handshake refused: {status!r}")
        accept = None
        selected = None
        while True:
            line = self._rfile.readline(8192)
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.partition(b":")
            header = name.strip().lower()
            if header == b"sec-websocket-accept":
                accept = value.strip().decode()
            elif header == b"sec-websocket-protocol":
                selected = value.strip().decode()
        expected = base64.b64encode(
            hashlib.sha1((key + _WS_MAGIC).encode()).digest()
        ).decode()
        if accept != expected:
            raise ConnectionError("websocket handshake: bad accept key")
        # a selection we never offered is a protocol violation — treat it
        # as no negotiation rather than trusting the server's framing claim
        if selected in self.subprotocols:
            self.subprotocol = selected

    # ── send ─────────────────────────────────────────────────────────────────

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        if CHAOS_HOOK is not None and opcode in (OP_TEXT, OP_BINARY):
            CHAOS_HOOK("send", len(payload))
        # masking hides frames from broken transparent proxies, not from
        # adversaries (RFC 6455 §10.3) — the PRNG mask is fine and skips a
        # urandom syscall per frame
        mask = random.randbytes(4)
        n = len(payload)
        if n < 126:
            header = struct.pack("!BB", 0x80 | opcode, 0x80 | n)
        elif n < (1 << 16):
            header = struct.pack("!BBH", 0x80 | opcode, 0x80 | 126, n)
        else:
            header = struct.pack("!BBQ", 0x80 | opcode, 0x80 | 127, n)
        # ONE copy of the payload into the frame buffer, masked in place —
        # megabyte report frames must not pay mask-copy + concat-copy
        frame = bytearray(len(header) + 4 + n)
        frame[: len(header)] = header
        frame[len(header): len(header) + 4] = mask
        frame[len(header) + 4:] = payload
        xor_mask_inplace(frame, mask, offset=len(header) + 4)
        self._sock.sendall(frame)

    def send(self, message: str | bytes | bytearray) -> None:
        if isinstance(message, str):
            self._send_frame(OP_TEXT, message.encode())
        else:
            self._send_frame(OP_BINARY, message)

    def send_text_bytes(self, payload: bytes) -> None:
        """Send an already-UTF-8-encoded TEXT frame — callers that
        assemble megabyte JSON frames as bytes skip the str round trip."""
        self._send_frame(OP_TEXT, payload)

    # ── recv ─────────────────────────────────────────────────────────────────

    def _read_exact(self, n: int) -> bytes:
        """Exactly ``n`` bytes, re-arming the socket timeout from
        ``self._deadline`` between underlying reads — a peer trickling
        one byte per (almost-)timeout must exhaust the recv budget, not
        reset it per read. ``read1`` issues at most one raw recv, so the
        deadline is consulted every time the wire actually stalls."""
        chunks: list[bytes] = []
        got = 0
        while got < n:
            if self._deadline is not None:
                remaining = self._deadline - time.monotonic()
                if remaining <= 0:
                    raise WSTimeout("websocket recv timed out")
                self._sock.settimeout(remaining)
            data = self._rfile.read1(n - got)
            if not data:
                raise WSConnectionClosed("socket closed mid-frame")
            chunks.append(data)
            got += len(data)
        return chunks[0] if len(chunks) == 1 else b"".join(chunks)

    def recv(self, timeout: float | None = None) -> str | bytes:
        """Next data message (str for text frames, bytes for binary);
        control frames are answered/absorbed inline. ``timeout`` bounds
        the WHOLE message: one deadline spans the frame loop AND every
        read inside a frame, so neither a slow trickle of fragments, a
        ping storm, nor a byte-at-a-time payload can stretch one recv
        far past the requested budget."""
        if CHAOS_HOOK is not None:
            CHAOS_HOOK("recv", 0)
        self._deadline = (
            time.monotonic() + timeout if timeout is not None else None
        )
        self._sock.settimeout(timeout)
        try:
            fragments: list[bytes] = []
            frag_opcode: int | None = None
            while True:
                b0, b1 = self._read_exact(2)
                opcode = b0 & 0x0F
                length = b1 & 0x7F
                if b1 & 0x80:
                    raise ConnectionError("server frames must be unmasked")
                if length == 126:
                    (length,) = struct.unpack("!H", self._read_exact(2))
                elif length == 127:
                    (length,) = struct.unpack("!Q", self._read_exact(8))
                if length > self.max_size:
                    raise ConnectionError(f"frame of {length} bytes > max_size")
                payload = self._read_exact(length) if length else b""
                if opcode == OP_PING:
                    self._send_frame(OP_PONG, payload)
                    continue
                if opcode == OP_PONG:
                    continue
                if opcode == OP_CLOSE:
                    try:
                        self._send_frame(OP_CLOSE, payload[:2])
                    except OSError:
                        pass
                    raise WSConnectionClosed("server sent close frame")
                if opcode in (OP_TEXT, OP_BINARY):
                    if frag_opcode is not None:
                        # RFC 6455 §5.4: data frames may not interleave
                        # with a fragmented message; silently dropping
                        # the buffered fragments would corrupt the
                        # stream position
                        raise WSConnectionClosed(
                            "data frame interleaved with fragments"
                        )
                    if not (b0 & 0x80):  # fragmented message begins
                        frag_opcode, fragments = opcode, [payload]
                        continue
                    return payload.decode() if opcode == OP_TEXT else payload
                if opcode == OP_CONT:
                    if frag_opcode is None:
                        raise ConnectionError("continuation without start")
                    fragments.append(payload)
                    if sum(map(len, fragments)) > self.max_size:
                        raise ConnectionError("fragmented message > max_size")
                    if b0 & 0x80:
                        whole = b"".join(fragments)
                        op, frag_opcode, fragments = frag_opcode, None, []
                        return whole.decode() if op == OP_TEXT else whole
                    continue
                raise ConnectionError(f"unexpected ws opcode {opcode}")
        except (socket.timeout, TimeoutError) as err:
            raise WSTimeout("websocket recv timed out") from err
        finally:
            self._sock.settimeout(None)

    def close(self) -> None:
        try:
            self._send_frame(OP_CLOSE, struct.pack("!H", 1000))
        except OSError:
            pass
        try:
            self._rfile.close()
        finally:
            try:
                self._sock.close()
            except OSError:
                pass
