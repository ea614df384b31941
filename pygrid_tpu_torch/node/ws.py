"""The Node's WebSocket endpoint.

Parity surface: reference ``events/__init__.py:90-107`` (``socket_api``: one
WS route at ``/``; JSON and binary frames through ``route_requests``; worker
unbound on socket close) served by gevent-websocket. Here: the port's own
RFC 6455 server (:mod:`pygrid_tpu_torch.web.websocket`) with the blocking
handler work pushed to a dedicated executor so device and sqlite calls
never stall the event loop. The reference's numpy XOR-masking fast path
(``util.py:5-24``) corresponds to ``native.xor_mask_inplace``, which
unmasks every client frame in place.

Wire v2: clients may offer the ``pygrid.wire.v2`` websocket subprotocol
(optionally ``+zstd``/``+zlib``) during the upgrade. On a negotiated
connection every binary frame carries a one-byte codec tag and may be
compressed; TEXT frames stay legacy JSON, and clients that never offer the
subprotocol get the v1 framing untouched — the fallback needs no server
configuration. The server takes the FIRST of the client's offers that it
can run, so a JAX client and a port node settle on the same codec.

The port's counterpart of :mod:`pygrid_tpu.node.ws`.
"""

from __future__ import annotations

import asyncio
import os
import time
from concurrent.futures import ThreadPoolExecutor

from pygrid_tpu_torch import telemetry, web
from pygrid_tpu_torch.node.events import Connection, _handler_of, route_requests
from pygrid_tpu_torch.serde import (
    decode_frame_traced,
    encode_frame,
    offered_subprotocols,
    serialize,
    subprotocol_codec,
    subprotocol_traced,
)
from pygrid_tpu_torch.telemetry import trace
from pygrid_tpu_torch.web import WSMsgType

#: every subprotocol variant this build can serve — the handshake picks
#: the first of the client's offers present here (client preference wins)
_SERVER_SUBPROTOCOLS = tuple(offered_subprotocols("auto"))

#: dedicated bounded pool for WS handler work, replacing the loop's
#: default executor: generation COMPUTE now runs on each serving
#: engine's own thread (serving/), so a generation burst can
#: no longer monopolize the process-wide default executor that other
#: subsystems share. A generation frame still *occupies* one of these
#: threads while it waits on the engine future (each WS connection
#: processes one frame at a time, so that's one thread per generating
#: client) — deployments expecting more than PYGRID_WS_THREADS
#: concurrent generating sockets should raise the knob or point bulk
#: generation at the async HTTP route, which holds no thread at all.
_WS_EXECUTOR = ThreadPoolExecutor(
    max_workers=int(os.environ.get("PYGRID_WS_THREADS", "32")),
    thread_name_prefix="pygrid-ws",
)


async def ws_handler(request: web.Request) -> web.StreamResponse:
    ctx = request.app["node"]
    if (
        request.headers.get("Upgrade", "").lower() != "websocket"
    ):  # plain GET / → dashboard for browsers, JSON for programs
        # (reference serves templates/index.html here, app/__init__.py:173)
        if "text/html" in request.headers.get("Accept", ""):
            from pygrid_tpu_torch.node.dashboard import render

            return web.Response(
                text=render(ctx.id), content_type="text/html"
            )
        return web.json_response(
            {"node_id": ctx.id, "message": "pygrid-tpu node"}
        )

    ws = web.WebSocketResponse(
        max_msg_size=256 * 1024 * 1024, protocols=_SERVER_SUBPROTOCOLS
    )
    await ws.prepare(request)
    conn = Connection(ctx, socket=ws)
    conn.wire_v2, conn.wire_codec = subprotocol_codec(ws.ws_protocol)
    #: trace headers on frames ONLY when the peer negotiated the
    #: ``.trace`` subprotocol variant — a plain-v2 peer's decoder
    #: predates the tag bit and would reject it
    wire_trace = subprotocol_traced(ws.ws_protocol)
    loop = asyncio.get_running_loop()
    codec_label = conn.wire_codec or ("v2" if conn.wire_v2 else "v1")

    def _unframe_route_frame(payload):
        if conn.wire_v2 and not isinstance(payload, str):
            t0 = time.perf_counter()
            try:
                payload, frame_trace = decode_frame_traced(payload)
            except ValueError as err:
                # a bad frame on a negotiated connection is a peer bug —
                # answer typed, keep the socket alive
                return encode_frame(
                    serialize({"error": f"bad wire-v2 frame: {err}"})
                )
            telemetry.observe(
                "ws_frame_decode_seconds", time.perf_counter() - t0
            )
            # one-shot: route_requests consumes it for the handler span
            conn.incoming_trace = trace.from_bytes(frame_trace)
        response = route_requests(ctx, payload, conn)
        # one-shot handler hint: a response embedding an already-
        # compressed payload (cached checkpoint) skips the envelope
        # codec pass — it would be redundant work per worker
        suppress, conn.suppress_frame_codec = conn.suppress_frame_codec, False
        served, conn.last_trace = conn.last_trace, None
        if conn.wire_v2 and isinstance(
            response, (bytes, bytearray, memoryview)
        ):
            codec = None if suppress else conn.wire_codec
            response = encode_frame(
                bytes(response), codec,
                trace=trace.to_bytes(served) if wire_trace else None,
            )
        return response

    def _process(payload):
        """Unframe → route → frame, all ON THE EXECUTOR THREAD: per-frame
        decompression/compression of megabyte payloads must not stall the
        event loop any more than the handlers themselves. (Byte counters:
        TEXT frames count characters — the JSON protocol is ASCII apart
        from user-supplied strings, so the drift is negligible and the
        alternative is re-encoding megabyte report frames.)"""
        telemetry.incr(
            "wire_bytes_total", len(payload), direction="in",
            codec=codec_label,
        )
        response = _unframe_route_frame(payload)
        if response is not None:
            telemetry.incr(
                "wire_bytes_total", len(response), direction="out",
                codec=codec_label,
            )
        return response

    try:
        async for msg in ws:
            if msg.type == WSMsgType.TEXT:
                payload: str | bytes = msg.data
            elif msg.type == WSMsgType.BINARY:
                payload = msg.data  # the unmasked buffer itself — no
                # defensive copy on the megabyte report path; handlers
                # never mutate frames
            else:
                continue
            response = await loop.run_in_executor(
                _WS_EXECUTOR, _process, payload
            )
            try:
                if isinstance(response, (bytes, bytearray, memoryview)):
                    await ws.send_bytes(bytes(response))
                elif response is not None:
                    await ws.send_str(response)
            except (ConnectionError, RuntimeError):
                # the peer vanished while the handler ran — a dropped
                # response to a dropped client is not a server error
                break
    finally:
        _handler_of(ctx).remove(ws)
    return ws
