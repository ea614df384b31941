"""Network HTTP routes.

Parity surface: reference ``apps/network/src/app/routes/network.py`` —
/join (:22), /connected-nodes (:55), /delete-node (:67),
/choose-encrypted-model-host (:98, n_replica × SMPC_HOST_CHUNK sampling),
/choose-model-host (:134), /search-encrypted-model (:157, fan-out),
/search-model (:201), /search-available-models (:229),
/search-available-tags (:247), /search (:266) — plus /models and /datasets
aggregates (``routes/models.py``, ``routes/dataset.py``) and the users CRUD
twin. Fan-outs run concurrently (asyncio.gather) instead of the reference's
sequential requests loop; per-node connection errors are swallowed the same
way (reference network.py:173-175).

The port's copy of :mod:`pygrid_tpu.network.routes`: the fan-outs go out on
the port's async client (:mod:`pygrid_tpu_torch.web.aioclient`) under the
same 10 s total.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
from typing import Any

from pygrid_tpu_torch import web
from pygrid_tpu_torch.network import SMPC_HOST_CHUNK, NetworkContext

logger = logging.getLogger(__name__)

INVALID_JSON_FORMAT_MESSAGE = "Invalid JSON format."


def _ctx(request: web.Request) -> NetworkContext:
    return request.app["network"]


async def _fanout(
    nodes: dict[str, str],
    path: str,
    method: str = "get",
    body: dict | None = None,
) -> dict[str, Any]:
    """Concurrently hit `path` on every node; unreachable nodes drop out."""
    timeout = web.ClientTimeout(total=10)

    async def one(node_id: str, address: str):
        try:
            async with web.ClientSession(timeout=timeout) as session:
                if method == "get":
                    async with session.get(address + path) as resp:
                        return node_id, await resp.json()
                async with session.post(address + path, json=body) as resp:
                    return node_id, await resp.json()
        except Exception:  # noqa: BLE001 — reference swallows ConnectionError
            return node_id, None

    results = await asyncio.gather(
        *(one(nid, addr) for nid, addr in nodes.items())
    )
    return {nid: payload for nid, payload in results if payload is not None}


# ── registry ────────────────────────────────────────────────────────────────


async def join(request: web.Request) -> web.Response:
    try:
        data = json.loads(await request.text())
        ok = _ctx(request).manager.register_new_node(
            data["node-id"], data["node-address"]
        )
        if ok:
            _ctx(request).proxy(data["node-id"], data["node-address"])
            return web.json_response({"message": "Successfully Connected!"})
        return web.json_response(
            {"message": "This ID has already been registered"}, status=409
        )
    except (ValueError, KeyError):
        return web.json_response(
            {"message": INVALID_JSON_FORMAT_MESSAGE}, status=400
        )


async def metrics(request: web.Request) -> web.Response:
    """Prometheus text exposition for the Network (nodes + proxy states) —
    the node app serves its own /metrics; the reference has neither
    (SURVEY §5.5)."""
    ctx = _ctx(request)
    from pygrid_tpu_torch import telemetry
    from pygrid_tpu_torch.utils.metrics import Exposition

    exp = Exposition()
    nodes = ctx.manager.connected_nodes()
    exp.gauge("grid_nodes_total", len(nodes),
              "nodes registered with the network")
    by_status: dict[str, int] = {}
    for proxy in ctx.proxies.values():
        by_status[proxy.status] = by_status.get(proxy.status, 0) + 1
    for status in ("online", "degraded", "busy", "offline"):
        exp.gauge("grid_nodes", by_status.get(status, 0),
                  "nodes by monitor status", {"status": status})
    exp.gauge("grid_subaggregators_total", len(ctx.aggregation.live()),
              "live sub-aggregators registered for placement")
    # the telemetry bus: request latency by route, heartbeat RTT by
    # transport, monitor poll outcomes, event counters
    telemetry.export(exp)
    # heartbeat SLO compliance/burn gauges (telemetry/slo.py)
    ctx.slo.export(exp)
    return web.Response(
        text=exp.render(), content_type="text/plain", charset="utf-8"
    )


async def connected_nodes(request: web.Request) -> web.Response:
    nodes = _ctx(request).manager.connected_nodes()
    return web.json_response({"grid-nodes": list(nodes.keys())})


async def delete_node(request: web.Request) -> web.Response:
    try:
        data = json.loads(await request.text())
        ok = _ctx(request).manager.delete_node(
            data["node-id"], data["node-address"]
        )
        if ok:
            _ctx(request).proxies.pop(data["node-id"], None)
            return web.json_response({"message": "Successfully Deleted!"})
        return web.json_response(
            {"message": "This ID was not found in connected nodes"}, status=409
        )
    except (ValueError, KeyError):
        return web.json_response(
            {"message": INVALID_JSON_FORMAT_MESSAGE}, status=400
        )


# ── host selection ──────────────────────────────────────────────────────────


async def choose_encrypted_model_host(request: web.Request) -> web.Response:
    """Sample n_replica × SMPC_HOST_CHUNK nodes to hold shares
    (reference network.py:98-131)."""
    ctx = _ctx(request)
    nodes = ctx.manager.connected_nodes()
    try:
        hosts = random.sample(
            list(nodes.keys()), ctx.n_replica * SMPC_HOST_CHUNK
        )
    except ValueError:  # not enough nodes
        return web.json_response([], status=400)
    return web.json_response([(h, nodes[h]) for h in hosts])


async def _get_model_hosting_nodes(
    ctx: NetworkContext, model_id: str
) -> list:
    nodes = ctx.manager.connected_nodes()
    results = await _fanout(nodes, "/data-centric/models/")
    return [
        (nid, nodes[nid])
        for nid, payload in results.items()
        if model_id in (payload.get("models") or [])
    ]


async def choose_model_host(request: web.Request) -> web.Response:
    ctx = _ctx(request)
    nodes = ctx.manager.connected_nodes()
    model_id = request.query.get("model_id")
    hosts_info = None
    if model_id:
        hosts_info = await _get_model_hosting_nodes(ctx, model_id)
    if not hosts_info:
        try:
            hosts = random.sample(list(nodes.keys()), ctx.n_replica or 1)
        except ValueError:
            return web.json_response([], status=400)
        hosts_info = [(h, nodes[h]) for h in hosts]
    return web.json_response(hosts_info)


# ── search fan-outs ─────────────────────────────────────────────────────────


async def search_encrypted_model(request: web.Request) -> web.Response:
    """(reference network.py:157-198) → {node: {address, nodes: {workers,
    crypto_provider}}} for every node hosting shares of the model."""
    ctx = _ctx(request)
    try:
        body = json.loads(await request.text())
    except ValueError:
        return web.json_response(
            {"message": INVALID_JSON_FORMAT_MESSAGE}, status=400
        )
    nodes = ctx.manager.connected_nodes()
    results = await _fanout(
        nodes, "/data-centric/search-encrypted-models", "post", body
    )
    match_nodes = {
        nid: {
            "address": nodes[nid],
            "nodes": payload,
            # share-holders/providers that are themselves grid nodes get
            # their addresses resolved here, so a client can dial them
            # without out-of-band knowledge (the reference assumes the
            # client already knows the grid map; this is strictly more)
            "worker_addresses": {
                wid: nodes[wid]
                for wid in (
                    payload.get("workers", [])
                    + payload.get("crypto_provider", [])
                )
                if wid in nodes
            },
        }
        for nid, payload in results.items()
        if {"workers", "crypto_provider"} <= set(payload.keys())
    }
    return web.json_response({"match-nodes": match_nodes})


async def search_model(request: web.Request) -> web.Response:
    try:
        body = json.loads(await request.text())
        match = await _get_model_hosting_nodes(_ctx(request), body["model_id"])
        return web.json_response({"match-nodes": match})
    except (ValueError, KeyError):
        return web.json_response(
            {"message": INVALID_JSON_FORMAT_MESSAGE}, status=400
        )


async def search_available_models(request: web.Request) -> web.Response:
    nodes = _ctx(request).manager.connected_nodes()
    results = await _fanout(nodes, "/data-centric/models/")
    models: set[str] = set()
    for payload in results.values():
        models.update(payload.get("models") or [])
    return web.json_response({"models": sorted(models)})


async def search_available_tags(request: web.Request) -> web.Response:
    nodes = _ctx(request).manager.connected_nodes()
    results = await _fanout(nodes, "/data-centric/dataset-tags")
    tags: set[str] = set()
    for payload in results.values():
        if isinstance(payload, list):
            tags.update(payload)
    return web.json_response({"tags": sorted(tags)})


async def search(request: web.Request) -> web.Response:
    """(reference network.py:266-306) dataset tag search → [(id, address)]."""
    ctx = _ctx(request)
    try:
        body = json.loads(await request.text())
        query = body["query"]
    except (ValueError, KeyError):
        return web.json_response(
            {"message": INVALID_JSON_FORMAT_MESSAGE}, status=400
        )
    nodes = ctx.manager.connected_nodes()
    results = await _fanout(
        nodes, "/data-centric/search", "post", {"query": query}
    )
    matches = [
        (nid, nodes[nid])
        for nid, payload in results.items()
        if payload.get("content")
    ]
    return web.json_response({"match-nodes": matches})


# ── hierarchical aggregation (docs/AGGREGATION.md) ──────────────────────────


async def aggregation_register(request: web.Request) -> web.Response:
    """A sub-aggregator registers (and re-registers as its heartbeat):
    ``{subagg-id, subagg-address, node-address}`` — the node (or parent
    sub-aggregator) address is the upstream its partials flow to."""
    try:
        data = json.loads(await request.text())
        entry = _ctx(request).aggregation.register(
            data["subagg-id"], data["subagg-address"], data["node-address"]
        )
    except (ValueError, KeyError, TypeError):
        return web.json_response(
            {"message": INVALID_JSON_FORMAT_MESSAGE}, status=400
        )
    return web.json_response(
        {"message": "registered", "ttl_s": _ctx(request).aggregation.ttl_s,
         "subagg-id": entry.subagg_id}
    )


async def aggregation_unregister(request: web.Request) -> web.Response:
    try:
        data = json.loads(await request.text())
        ok = _ctx(request).aggregation.remove(data["subagg-id"])
    except (ValueError, KeyError):
        return web.json_response(
            {"message": INVALID_JSON_FORMAT_MESSAGE}, status=400
        )
    return web.json_response(
        {"message": "removed" if ok else "unknown sub-aggregator"},
        status=200 if ok else 404,
    )


async def aggregation_placement(request: web.Request) -> web.Response:
    """Worker→sub-aggregator routing: ``?node-address=…&worker-id=…`` →
    ``{report-to: address | null}``. Null means report direct to the
    node — the fallback whenever no live sub-aggregator serves it."""
    node_address = request.query.get("node-address")
    worker_id = request.query.get("worker-id")
    if not node_address or not worker_id:
        return web.json_response(
            {"message": "node-address and worker-id are required"},
            status=400,
        )
    entry = _ctx(request).aggregation.place(node_address, worker_id)
    return web.json_response(
        {
            "report-to": entry.address if entry else None,
            "subagg-id": entry.subagg_id if entry else None,
        }
    )


async def aggregation_tree(request: web.Request) -> web.Response:
    """The live tree topology + knobs (fanout/depth/ttl) for operators
    and the dashboard."""
    return web.json_response(_ctx(request).aggregation.tree())


# ── monitor aggregates (reference routes/models.py, routes/dataset.py) ──────


async def models(request: web.Request) -> web.Response:
    ctx = _ctx(request)
    return web.json_response(
        {"models": [p.hosted_models for p in ctx.proxies.values()]}
    )


async def datasets(request: web.Request) -> web.Response:
    ctx = _ctx(request)
    return web.json_response(
        {"datasets": [p.hosted_datasets for p in ctx.proxies.values()]}
    )


async def telemetry_slo(request: web.Request) -> web.Response:
    """The network's burn-rate SLO view (heartbeat RTT, per-node burn
    under ``by_node``) — twin of the node's route, same payload shape."""
    return web.json_response({"slo": _ctx(request).slo.evaluate()})


async def healthz(request: web.Request) -> web.Response:
    """Shallow 200 for LB probes; ``?deep=1`` answers 503 when the
    heartbeat SLO is in breach or a majority of nodes are unreachable."""
    if request.query.get("deep") not in ("1", "true", "yes"):
        return web.json_response({"status": "ok"})
    ctx = _ctx(request)
    rows = ctx.slo.evaluate()
    breaches = [r["name"] for r in rows if r["status"] == "breach"]
    proxies = list(ctx.proxies.values())
    offline = [p.id for p in proxies if p.status == "offline"]
    unhealthy = bool(breaches) or (
        len(proxies) > 0 and len(offline) > len(proxies) / 2
    )
    return web.json_response(
        {
            "status": "breach" if unhealthy else "ok",
            "breaches": breaches,
            "nodes_offline": offline,
            "nodes_total": len(proxies),
            "slo": rows,
        },
        status=503 if unhealthy else 200,
    )


async def nodes_status(request: web.Request) -> web.Response:
    ctx = _ctx(request)
    return web.json_response(
        {
            nid: {
                "address": p.address,
                "status": p.status,
                "ping_ms": p.ping,
                "models": p.hosted_models,
                "datasets": p.hosted_datasets,
                "location": p.location,
            }
            for nid, p in ctx.proxies.items()
        }
    )


def register(app: web.Application) -> None:
    from pygrid_tpu_torch.users.events import http_twin
    from pygrid_tpu_torch.utils.codes import ROLE_EVENTS, USER_EVENTS

    def _rbac_twin(event_type):
        # the shared twin: path params win over body keys, malformed
        # input maps to 400 (see users/events.py http_twin)
        return http_twin(event_type, "network")

    r = app.router
    r.add_post("/join", join)
    r.add_get("/connected-nodes", connected_nodes)
    r.add_get("/metrics", metrics)
    r.add_delete("/delete-node", delete_node)
    r.add_get("/choose-encrypted-model-host", choose_encrypted_model_host)
    r.add_get("/choose-model-host", choose_model_host)
    r.add_post("/search-encrypted-model", search_encrypted_model)
    r.add_post("/search-model", search_model)
    r.add_get("/search-available-models", search_available_models)
    r.add_get("/search-available-tags", search_available_tags)
    r.add_post("/search", search)
    r.add_get("/models", models)
    r.add_get("/datasets", datasets)
    r.add_get("/nodes-status", nodes_status)
    r.add_post("/aggregation/register", aggregation_register)
    r.add_delete("/aggregation/register", aggregation_unregister)
    r.add_get("/aggregation/placement", aggregation_placement)
    r.add_get("/aggregation/tree", aggregation_tree)
    r.add_get("/telemetry/slo", telemetry_slo)
    r.add_get("/healthz", healthz)
    r.add_post("/users/signup", _rbac_twin(USER_EVENTS.SIGNUP_USER))
    r.add_post("/users/login", _rbac_twin(USER_EVENTS.LOGIN_USER))
    r.add_get("/users/", _rbac_twin(USER_EVENTS.GET_ALL_USERS))
    r.add_get("/users/{id}", _rbac_twin(USER_EVENTS.GET_SPECIFIC_USER))
    r.add_put("/users/{id}/email", _rbac_twin(USER_EVENTS.PUT_EMAIL))
    r.add_put("/users/{id}/password", _rbac_twin(USER_EVENTS.PUT_PASSWORD))
    r.add_put("/users/{id}/role", _rbac_twin(USER_EVENTS.PUT_ROLE))
    r.add_delete("/users/{id}", _rbac_twin(USER_EVENTS.DELETE_USER))
    r.add_post("/roles/", _rbac_twin(ROLE_EVENTS.CREATE_ROLE))
    r.add_get("/roles/", _rbac_twin(ROLE_EVENTS.GET_ALL_ROLES))
    r.add_get("/roles/{id}", _rbac_twin(ROLE_EVENTS.GET_ROLE))
    r.add_put("/roles/{id}", _rbac_twin(ROLE_EVENTS.PUT_ROLE))
    r.add_delete("/roles/{id}", _rbac_twin(ROLE_EVENTS.DELETE_ROLE))
