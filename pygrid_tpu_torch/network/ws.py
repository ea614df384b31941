"""Network WS endpoint: join / forward / monitor-answer.

Parity surface: reference ``apps/network/src/app/events/network.py`` —
``join`` registers the node's socket and starts monitoring (:25-43),
``monitor-answer`` updates the node's cached stats (:11-22), ``forward``
routes a payload to a destination node's socket (:46-61). On socket loss the
node is marked offline and reattaches on rejoin (reference
``events/socket_handler.py:36-38,63-70``). The port's copy of
:mod:`pygrid_tpu.network.ws`, on the port's RFC 6455 server; a plain GET
on ``/`` answers the landing JSON.
"""

from __future__ import annotations

import json
import logging

from pygrid_tpu_torch import web
from pygrid_tpu_torch.web import WSMsgType

from pygrid_tpu_torch.network import NetworkContext
from pygrid_tpu_torch.utils.codes import NODE_EVENTS

logger = logging.getLogger(__name__)


async def _handle(ctx: NetworkContext, message: dict, ws) -> dict | None:
    msg_type = message.get("type")
    data = message.get("data") or message

    # user/role/group WS twins — same table the Node serves (reference
    # apps/network/src/app/events/__init__.py:12-30)
    from pygrid_tpu_torch.users.events import USER_HANDLERS

    if msg_type in USER_HANDLERS:
        return USER_HANDLERS[msg_type](ctx, message)

    if msg_type == NODE_EVENTS.JOIN:
        node_id = data.get("node-id") or data.get("id")
        address = data.get("node-address") or data.get("address")
        ctx.manager.register_new_node(node_id, address)
        proxy = ctx.proxy(node_id, address)
        proxy.socket = ws
        proxy.ping = 0.0
        return {"status": "Successfully Connected!", "id": node_id}

    if msg_type == NODE_EVENTS.MONITOR_ANSWER:
        node_id = data.get("id")
        proxy = ctx.proxies.get(node_id)
        if proxy is not None:
            proxy.update_from_answer(data)
        return None

    if msg_type == NODE_EVENTS.FORWARD:
        dest = data.get("destination")
        proxy = ctx.proxies.get(dest)
        if proxy is None or proxy.socket is None:
            return {"error": f"node {dest!r} not connected"}
        await proxy.socket.send_str(json.dumps(data.get("content")))
        return {"status": "forwarded"}

    return {"error": f"unknown event {msg_type!r}"}


async def ws_handler(request: web.Request) -> web.StreamResponse:
    ctx = request.app["network"]
    if request.headers.get("Upgrade", "").lower() != "websocket":
        return web.json_response(
            {"network_id": ctx.id, "message": "pygrid-tpu network"}
        )
    ws = web.WebSocketResponse()
    await ws.prepare(request)
    try:
        async for msg in ws:
            if msg.type != WSMsgType.TEXT:
                continue
            message = {}
            try:
                message = json.loads(msg.data)
                response = await _handle(ctx, message, ws)
            except Exception as err:  # noqa: BLE001 — protocol boundary
                response = {"error": str(err)}
            if response is not None:
                if isinstance(message, dict) and message.get("request_id"):
                    response["request_id"] = message["request_id"]
                try:
                    await ws.send_str(json.dumps(response))
                except (ConnectionError, RuntimeError):
                    break  # peer vanished mid-handler — not a server error
    finally:
        for proxy in ctx.proxies.values():
            if proxy.socket is ws:
                proxy.mark_offline()
    return ws
