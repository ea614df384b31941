"""Network app — the grid directory + router.

Parity surface: reference ``apps/network/src/app/`` — app factory
(``__init__.py:91-197``), node registry (``network/network_manager.py``),
WS events join/forward/monitor-answer (``events/network.py``), node-proxy
monitor (``workers/worker.py``), HTTP fan-out routes
(``routes/network.py``), RBAC twin. One asyncio application.

The port's counterpart of :mod:`pygrid_tpu.network`, served by the port's
own :mod:`pygrid_tpu_torch.web` (the card's machine has no aiohttp), with
its outgoing calls on :mod:`pygrid_tpu_torch.web.aioclient`. The network
holds no tensor — it is a directory of nodes and sub-aggregators, their
health and the search fan-outs — so, unlike the node, it takes no
``device``.
"""

from __future__ import annotations

import secrets

from pygrid_tpu_torch.network.manager import NetworkManager
from pygrid_tpu_torch.network.monitor import NodeProxy
from pygrid_tpu_torch.storage.warehouse import Database
from pygrid_tpu_torch.users import UserManager

__version__ = "0.1.0"

#: minimum nodes required to host an encrypted model (reference
#: apps/network/src/app/routes/network.py:16)
SMPC_HOST_CHUNK = 4


class NetworkContext:
    def __init__(
        self,
        network_id: str = "network",
        database_url: str = ":memory:",
        secret_key: str | None = None,
        n_replica: int = 1,
        monitor_interval: float = 15.0,
    ) -> None:
        self.id = network_id
        self.db = Database(database_url)
        self.secret_key = secret_key or secrets.token_hex(16)
        self.n_replica = n_replica
        self.monitor_interval = monitor_interval
        self.manager = NetworkManager(self.db)
        self.users = UserManager(self.db, secret_key=self.secret_key)
        #: node_id → live proxy (socket- or poll-backed)
        self.proxies: dict[str, NodeProxy] = {}
        # heartbeat-RTT burn-rate SLO, grouped per node — the monitor
        # marks nodes *degraded* (alive but eating latency budget) from
        # this engine's state, beyond the reference's alive/dead binary
        from pygrid_tpu_torch.telemetry.slo import SLOEngine, network_objectives

        self.slo = SLOEngine(network_objectives())
        # hierarchical-aggregation placement: sub-aggregator registry +
        # worker→sub-aggregator routing (docs/AGGREGATION.md); swept for
        # liveness by the same monitor loop that heartbeats nodes
        from pygrid_tpu_torch import telemetry
        from pygrid_tpu_torch.network.aggregation import AggregationRegistry

        self.aggregation = AggregationRegistry()
        telemetry.recorder.register_stats_provider(
            "aggregation", self.aggregation
        )

    def proxy(self, node_id: str, address: str) -> NodeProxy:
        if node_id not in self.proxies:
            self.proxies[node_id] = NodeProxy(node_id, address)
        return self.proxies[node_id]


def create_app(
    network_id: str = "network",
    database_url: str = ":memory:",
    secret_key: str | None = None,
    n_replica: int = 1,
    monitor_interval: float = 15.0,
):
    import asyncio
    import contextlib

    from pygrid_tpu_torch import telemetry, web
    from pygrid_tpu_torch.network import routes as R
    from pygrid_tpu_torch.network.ws import ws_handler

    ctx = NetworkContext(
        network_id,
        database_url=database_url,
        secret_key=secret_key,
        n_replica=n_replica,
        monitor_interval=monitor_interval,
    )
    app = web.Application(middlewares=[telemetry.http_middleware()])
    app["network"] = ctx
    app.router.add_get("/", ws_handler)
    R.register(app)

    async def _start_monitor(app_):
        from pygrid_tpu_torch.network.monitor import monitor_loop

        # periodic engine snapshots: placement/tree trajectory on the
        # flight-recorder ring (docs/OBSERVABILITY.md §7)
        telemetry.recorder.start_snapshots()
        app_["monitor_task"] = asyncio.get_running_loop().create_task(
            monitor_loop(ctx)
        )

    async def _stop_monitor(app_):
        task = app_.get("monitor_task")
        if task:
            task.cancel()
            # wait the sweep out: a poll in flight holds a connection
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await task
        await asyncio.get_running_loop().run_in_executor(
            None, telemetry.recorder.stop_snapshots
        )

    app.on_startup.append(_start_monitor)
    app.on_cleanup.append(_stop_monitor)
    return app
