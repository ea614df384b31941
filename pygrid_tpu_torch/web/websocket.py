"""The server side of RFC 6455 over the port's HTTP server.

``WebSocketResponse(protocols=..., max_msg_size=...)``: ``await
ws.prepare(request)`` answers the upgrade (``Sec-WebSocket-Accept``, and
of the client's offered subprotocols the FIRST one the server lists, as
aiohttp chooses); ``async for msg in ws`` yields TEXT and BINARY
messages (:class:`WSMessage` with a :class:`WSMsgType`), joining
continuation frames, answering pings with pongs and ending on the close
handshake; ``send_str``/``send_bytes`` send unmasked frames and await the
transport's drain. Client frames must be masked; each payload is read
into one buffer and unmasked in place by ``native.xor_mask_inplace``.
Lengths use the 7-, 16- and 64-bit forms, up to ``max_msg_size`` a
message (frames or the joined fragments); past it the server closes with
1009.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import contextlib
import enum
import hashlib
import struct
from typing import Any, NamedTuple

from pygrid_tpu_torch.native import xor_mask_inplace
from pygrid_tpu_torch.web.server import HTTPBadRequest, Request, StreamResponse

WS_MAGIC = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA

#: how long ``close()`` waits for the peer's closing frame
CLOSE_TIMEOUT_S = 2.0


class WSMsgType(enum.IntEnum):
    CONTINUATION = OP_CONT
    TEXT = OP_TEXT
    BINARY = OP_BINARY
    PING = OP_PING
    PONG = OP_PONG
    CLOSE = OP_CLOSE
    CLOSING = 0x100
    CLOSED = 0x101
    ERROR = 0x102


class WSMessage(NamedTuple):
    type: WSMsgType
    data: Any
    extra: Any


class _ProtocolError(Exception):
    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code


def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``."""
    return base64.b64encode(hashlib.sha1(key.encode() + WS_MAGIC).digest()).decode()


async def _read_into(reader: asyncio.StreamReader, n: int) -> bytearray:
    """Exactly ``n`` bytes in one new buffer, copied from the stream as
    they arrive."""
    buf = bytearray(n)
    with memoryview(buf) as view:
        pos = 0
        while pos < n:
            chunk = await reader.read(min(n - pos, 1 << 20))
            if not chunk:
                raise asyncio.IncompleteReadError(bytes(view[:pos]), n)
            view[pos:pos + len(chunk)] = chunk
            pos += len(chunk)
    return buf


class WebSocketResponse(StreamResponse):
    def __init__(self, *, protocols: tuple[str, ...] | list[str] = (),
                 max_msg_size: int = 4 * 1024 * 1024) -> None:
        super().__init__(status=101)
        self._protocols = tuple(protocols)
        self._max_msg_size = max_msg_size
        self.ws_protocol: str | None = None
        self.close_code: int | None = None
        self._reader: asyncio.StreamReader | None = None
        self._closing_sent = False
        self._closed = False

    async def prepare(self, request: Request) -> None:
        if self.prepared:
            return
        h = request.headers
        connection = {t.strip().lower() for t in h.get("Connection", "").split(",")}
        if request.method != "GET" or h.get("Upgrade", "").lower() != "websocket" \
                or "upgrade" not in connection:
            raise HTTPBadRequest(text="No WebSocket UPGRADE hdr")
        if h.get("Sec-WebSocket-Version") != "13":
            raise HTTPBadRequest(text="Unsupported version: "
                                      f"{h.get('Sec-WebSocket-Version')}")
        key = h.get("Sec-WebSocket-Key", "")
        try:
            if len(base64.b64decode(key, validate=True)) != 16:
                raise ValueError
        except (binascii.Error, ValueError):
            raise HTTPBadRequest(text=f"Handshake error: {key!r}") from None
        offers = [p.strip() for p in h.get("Sec-WebSocket-Protocol", "").split(",") if p.strip()]
        self.ws_protocol = next((p for p in offers if p in self._protocols), None)
        self.headers["Upgrade"] = "websocket"
        self.headers["Connection"] = "upgrade"
        self.headers["Sec-WebSocket-Accept"] = accept_key(key)
        if self.ws_protocol:
            self.headers["Sec-WebSocket-Protocol"] = self.ws_protocol
        request.keep_alive = False
        self._reader = request._reader
        self._writer = request._writer
        lines = ["HTTP/1.1 101 Switching Protocols"]
        lines += [f"{k}: {v}" for k, v in self.headers.items()]
        self._writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
        await self._writer.drain()
        self.prepared = True

    # ── sending ───────────────────────────────────────────────────────────

    async def _send_frame(self, opcode: int, payload: bytes | bytearray | memoryview) -> None:
        if self._closing_sent or self._writer is None or self._writer.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        n = len(payload)
        if n < 126:
            header = struct.pack("!BB", 0x80 | opcode, n)
        elif n < (1 << 16):
            header = struct.pack("!BBH", 0x80 | opcode, 126, n)
        else:
            header = struct.pack("!BBQ", 0x80 | opcode, 127, n)
        self._writer.write(header)
        if n:
            self._writer.write(payload)
        await self._writer.drain()

    async def send_str(self, data: str) -> None:
        await self._send_frame(OP_TEXT, data.encode("utf-8"))

    async def send_bytes(self, data: bytes | bytearray | memoryview) -> None:
        await self._send_frame(OP_BINARY, data)

    async def close(self, *, code: int = 1000, message: bytes = b"") -> bool:
        """Send a close frame (once) and wait briefly for the peer's."""
        if self._closing_sent or self._writer is None:
            return False
        with contextlib.suppress(ConnectionError):
            await self._send_frame(OP_CLOSE, struct.pack("!H", code) + message)
        self._closing_sent = True
        self.close_code = self.close_code or code
        if not self._closed:
            with contextlib.suppress(Exception):
                await asyncio.wait_for(self._await_peer_close(), CLOSE_TIMEOUT_S)
        self._closed = True
        return True

    async def _await_peer_close(self) -> None:
        while True:
            _, opcode, _ = await self._read_frame()
            if opcode == OP_CLOSE:
                return

    # ── receiving ─────────────────────────────────────────────────────────

    async def _read_frame(self) -> tuple[bool, int, bytearray]:
        b0, b1 = await self._reader.readexactly(2)
        if b0 & 0x70:
            raise _ProtocolError(1002, "reserved bits set")
        fin, opcode = bool(b0 & 0x80), b0 & 0x0F
        if not b1 & 0x80:
            raise _ProtocolError(1002, "client frames must be masked")
        n = b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack("!H", await self._reader.readexactly(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", await self._reader.readexactly(8))
        if opcode >= 0x8 and (n > 125 or not fin):
            raise _ProtocolError(1002, "bad control frame")
        if n > self._max_msg_size:
            raise _ProtocolError(1009, f"message size {n} exceeds limit {self._max_msg_size}")
        mask = await self._reader.readexactly(4)
        payload = await _read_into(self._reader, n) if n else bytearray()
        xor_mask_inplace(payload, mask)
        return fin, opcode, payload

    async def receive(self) -> WSMessage:
        """The next data message; control frames are handled here."""
        if self._closed:
            return WSMessage(WSMsgType.CLOSED, None, None)
        fragments: list[bytearray] = []
        frag_op: int | None = None
        size = 0
        while True:
            try:
                fin, opcode, payload = await self._read_frame()
            except (asyncio.IncompleteReadError, ConnectionError):
                self._closed = True
                return WSMessage(WSMsgType.CLOSED, None, None)
            except _ProtocolError as err:
                await self.close(code=err.code, message=str(err).encode()[:120])
                return WSMessage(WSMsgType.ERROR, err, None)
            if opcode == OP_PING:
                await self._send_frame(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else 1005
                self.close_code = code
                if not self._closing_sent:
                    with contextlib.suppress(ConnectionError):
                        await self._send_frame(OP_CLOSE, bytes(payload[:2]))
                    self._closing_sent = True
                self._closed = True
                return WSMessage(WSMsgType.CLOSE, code, bytes(payload[2:]).decode(errors="replace"))
            if opcode in (OP_TEXT, OP_BINARY):
                if frag_op is not None:
                    err = _ProtocolError(1002, "data frame inside a fragmented message")
                elif fin:
                    return await self._message(opcode, payload)
                else:
                    frag_op, fragments, size = opcode, [payload], len(payload)
                    continue
            elif opcode == OP_CONT:
                if frag_op is None:
                    err = _ProtocolError(1002, "continuation without a start")
                else:
                    size += len(payload)
                    if size > self._max_msg_size:
                        err = _ProtocolError(1009, f"message size {size} exceeds limit "
                                                   f"{self._max_msg_size}")
                    else:
                        fragments.append(payload)
                        if not fin:
                            continue
                        whole = bytearray().join(fragments)
                        return await self._message(frag_op, whole)
            else:
                err = _ProtocolError(1002, f"unknown opcode {opcode:#x}")
            await self.close(code=err.code, message=str(err).encode()[:120])
            return WSMessage(WSMsgType.ERROR, err, None)

    async def _message(self, opcode: int, payload: bytearray) -> WSMessage:
        if opcode == OP_BINARY:
            return WSMessage(WSMsgType.BINARY, payload, None)
        try:
            return WSMessage(WSMsgType.TEXT, payload.decode("utf-8"), None)
        except UnicodeDecodeError as err:
            await self.close(code=1007, message=b"invalid utf-8")
            return WSMessage(WSMsgType.ERROR, err, None)

    def __aiter__(self) -> "WebSocketResponse":
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.CLOSED,
                        WSMsgType.ERROR):
            raise StopAsyncIteration
        return msg
