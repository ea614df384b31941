"""Node health monitoring.

Parity surface: reference ``apps/network/src/app/workers/worker.py`` — a
per-node proxy tracking ping / status (online < 5s ping < busy; no contact →
offline), cached hosted models/datasets/cpu/mem, refreshed by a 15 s
heartbeat loop (``worker.py:67-86``; constants ``codes.py:51-56``). The
reference pushes a WS ``monitor`` message and waits for ``monitor-answer``;
here the loop *also* falls back to HTTP polling of the node's public
endpoints, so socketless (HTTP-joined) nodes are monitored identically.

The port's copy of :mod:`pygrid_tpu.network.monitor`: the polls go out on
the port's async client (:mod:`pygrid_tpu_torch.web.aioclient`).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

from pygrid_tpu_torch import telemetry
from pygrid_tpu_torch.utils.codes import NODE_EVENTS

logger = logging.getLogger(__name__)

PING_THRESHOLD_MS = 5000.0  # reference WORKER_PROPERTIES.PING_THRESHOLD
ONLINE, BUSY, OFFLINE = "online", "busy", "offline"
#: alive, but burning its heartbeat-latency budget (telemetry/slo.py) —
#: the state between "fine" and "dead" the reference cannot express
DEGRADED = "degraded"


class NodeProxy:
    def __init__(self, node_id: str, address: str, socket: Any = None) -> None:
        self.id = node_id
        self.address = address
        self.socket = socket
        self.ping: float | None = None  # ms
        self.last_seen: float | None = None
        self.connected_nodes: list = []
        self.hosted_models: list = []
        self.hosted_datasets: list = []
        self.cpu_percent: float | None = None
        self.mem_usage: float | None = None
        #: reference worker.py:47-61 resolves this via an external geo-IP
        #: service; here nodes self-report it (NODE_LOCATION env / monitor
        #: answer) — no egress dependency
        self.location: str | None = None
        self._monitor_sent_at: float | None = None
        #: set by the monitor sweep from the network SLO engine's
        #: per-node heartbeat burn state (monitor_loop)
        self.degraded: bool = False

    @property
    def status(self) -> str:
        if self.ping is None:
            return OFFLINE
        if self.ping >= PING_THRESHOLD_MS:
            return BUSY
        if self.degraded:
            return DEGRADED
        return ONLINE

    def mark_offline(self) -> None:
        self.ping = None
        self.socket = None

    def monitor_sent(self) -> None:
        self._monitor_sent_at = time.monotonic()

    def update_from_answer(self, message: dict) -> None:
        """WS monitor-answer payload (reference worker.py:76-86)."""
        if self._monitor_sent_at is not None:
            self.ping = (time.monotonic() - self._monitor_sent_at) * 1000
            self._monitor_sent_at = None  # a duplicate answer must not
            # recompute ping from this consumed timestamp
            telemetry.observe(
                "heartbeat_rtt_seconds", self.ping / 1000.0,
                transport="ws", node=self.id,
            )
            telemetry.incr(
                "monitor_polls_total", 1, outcome="online", node=self.id
            )
        self.last_seen = time.time()
        self.connected_nodes = message.get("nodes") or []
        self.hosted_models = message.get("models") or []
        self.hosted_datasets = message.get("datasets") or []
        self.cpu_percent = message.get("cpu")
        self.mem_usage = message.get("mem")
        if message.get("location"):
            self.location = message["location"]


async def poll_node(proxy: NodeProxy) -> None:
    """HTTP fallback heartbeat: status + models + dataset tags. Exactly
    ONE ``monitor_polls_total`` sample per poll, decided by how the whole
    sweep ended — a 200 on /status followed by a failing /models fetch is
    one offline poll, not one of each."""
    from pygrid_tpu_torch import web

    t0 = time.monotonic()
    outcome = "offline"
    try:
        timeout = web.ClientTimeout(total=5)
        async with web.ClientSession(timeout=timeout) as session:
            async with session.get(
                proxy.address + "/data-centric/status/"
            ) as resp:
                if resp.status != 200:
                    proxy.mark_offline()
                    return
                status = await resp.json()
                if status.get("location"):
                    proxy.location = status["location"]
            proxy.ping = (time.monotonic() - t0) * 1000
            proxy.last_seen = time.time()
            async with session.get(
                proxy.address + "/data-centric/models/"
            ) as resp:
                proxy.hosted_models = (await resp.json()).get("models", [])
            async with session.get(
                proxy.address + "/data-centric/dataset-tags"
            ) as resp:
                proxy.hosted_datasets = await resp.json()
        outcome = "online"
        telemetry.observe(
            "heartbeat_rtt_seconds", proxy.ping / 1000.0,
            transport="http", node=proxy.id,
        )
    except Exception:  # noqa: BLE001 — unreachable node is a data point
        proxy.mark_offline()
    finally:
        telemetry.incr(
            "monitor_polls_total", 1, outcome=outcome, node=proxy.id
        )


async def monitor_loop(ctx) -> None:
    """15 s heartbeat across all registered nodes (reference worker.py:67-74).
    Socket-joined nodes get a WS `monitor` push; the rest are HTTP-polled."""
    import json

    while True:
        try:
            for node_id, address in ctx.manager.connected_nodes().items():
                proxy = ctx.proxy(node_id, address)
                if proxy.socket is not None:
                    try:
                        proxy.monitor_sent()
                        await proxy.socket.send_str(
                            json.dumps({"type": NODE_EVENTS.MONITOR})
                        )
                    except Exception:  # noqa: BLE001
                        proxy.mark_offline()
                else:
                    await poll_node(proxy)
            mark_degraded(ctx)
            aggregation = getattr(ctx, "aggregation", None)
            if aggregation is not None:
                # heartbeat-loss sweep: a silent sub-aggregator stops
                # receiving placements, so its subtree's workers fall
                # back to direct node reports (docs/AGGREGATION.md)
                for sid in aggregation.sweep():
                    logger.warning(
                        "sub-aggregator %s heartbeat lost — removed "
                        "from placement", sid,
                    )
        except Exception:  # noqa: BLE001 — keep the loop alive
            logger.exception("monitor sweep failed")
        await asyncio.sleep(ctx.monitor_interval)


def mark_degraded(ctx) -> None:
    """Fold the SLO engine's per-node heartbeat burn state into proxy
    status: burn > 1 means the node is answering, but slower than its
    latency budget sustains — degraded, not dead. Sweeps also snapshot
    the engine so the burn windows have data at monitor cadence. The
    verdict needs MIN_EVENTS heartbeats in the window: one slow first
    poll from a freshly joined node is not a degradation."""
    from pygrid_tpu_torch.telemetry.slo import MIN_EVENTS

    slo = getattr(ctx, "slo", None)
    if slo is None:
        return
    # evaluate (which ticks internally) rather than bare tick: status
    # transitions are detected in evaluate, so the network's breach
    # webhooks fire at monitor cadence even when nobody scrapes
    slo.evaluate()
    burn = slo.group_burn("heartbeat_rtt", min_events=MIN_EVENTS)
    for node_id, proxy in ctx.proxies.items():
        proxy.degraded = burn.get(node_id, 0.0) > 1.0
