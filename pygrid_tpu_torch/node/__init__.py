"""Node app — the coordination-plane server, on the card.

Parity surface: reference ``apps/node/src/app/__init__.py`` (create_app:131,
seed_db:79, blueprints /, /model-centric, /data-centric + WS at
``:173-178``) and ``apps/node/src/__main__.py`` (CLI + network join + server).
The reference serves gevent WSGI + Flask-Sockets; here it is one asyncio
application of the port's own :mod:`pygrid_tpu_torch.web` layer carrying
HTTP routes and the WebSocket endpoint.

``NodeContext`` is the app-wide singleton the reference scatters across
module globals (local_worker, model_controller, session repo, FLController):
one object, explicitly threaded through handlers. The port's counterpart of
:mod:`pygrid_tpu.node`: the context holds one explicit ``torch.device``
(default ``"cuda"``; without a GPU it raises unless ``device="cpu"``), and
the node's parties, sessions, dealer, hosted models and serving engines all
live on it. Handlers run on executor threads, so nothing reads the
thread-local current CUDA device: every tensor goes to ``ctx.device``. The
FL cycle's averaging stays on the host, as in the reference.
"""

from __future__ import annotations

import os
import secrets

import torch

from pygrid_tpu_torch.datacentric import (
    KVStore,
    MemoryKV,
    ModelController,
    SessionsRepository,
    SqliteKV,
    set_persistent_mode,
)
from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.federated.controller import FLController
from pygrid_tpu_torch.runtime.worker import VirtualWorker
from pygrid_tpu_torch.storage.warehouse import Database
from pygrid_tpu_torch.users import UserManager

__version__ = "0.1.0"


class NodeContext:
    """Everything one Node owns (reference main/__init__.py:8-17 globals +
    app factory wiring)."""

    def __init__(
        self,
        node_id: str,
        database_url: str = ":memory:",
        kv: KVStore | None = None,
        kv_path: str | None = None,
        secret_key: str | None = None,
        network_url: str | None = None,
        num_replicas: int | None = None,
        strict_crypto_store: bool = False,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve(device)
        self.id = node_id
        self.address: str | None = None
        self.network_url = network_url
        self.num_replicas = num_replicas
        self.db = Database(database_url)
        self.kv: KVStore = (
            kv
            if kv is not None
            else (SqliteKV(kv_path) if kv_path else MemoryKV())
        )
        self.secret_key = secret_key or secrets.token_hex(16)

        # the Node's singleton party (reference local_worker)
        self.local_worker = VirtualWorker(id=node_id, device=self.device)
        set_persistent_mode(self.local_worker, self.kv)
        # every node can act as a cross-node triple dealer (the reference's
        # crypto-provider worker, e.g. james in
        # test_basic_syft_operations.py:455-491); strict mode reproduces
        # the EmptyCryptoPrimitiveStoreError refill round-trip
        from pygrid_tpu_torch.smpc.provider import CryptoProvider

        self.crypto_provider = CryptoProvider(
            id=f"{node_id}-crypto",
            strict_store=strict_crypto_store,
            device=self.device,
        )
        self.local_worker.crypto_provider = self.crypto_provider

        self.fl = FLController(self.db)
        # a restarted node resumes mid-process from SQL (reference posture,
        # SURVEY §5.4); deadlined open cycles need their timers re-armed,
        # and secagg cycles whose in-memory key rounds died close
        # explicitly so clients re-key instead of polling a dead round
        self.fl.cycle_manager.recover_deadlines()
        self.fl.cycle_manager.recover_secagg()
        self.models = ModelController(self.kv, device=self.device)
        self.sessions = SessionsRepository(device=self.device)
        self.users = UserManager(self.db, secret_key=self.secret_key)
        # continuous-batching generation engines, one per hosted
        # transformer bundle (serving/) — cheap to construct (engines
        # build lazily on first request); slot/queue depth are the ops
        # sizing knobs
        from pygrid_tpu_torch.serving import EngineConfig, ServingManager

        self.serving = ServingManager(
            EngineConfig(
                max_slots=int(os.environ.get("PYGRID_SERVING_SLOTS", "8")),
                max_queue=int(os.environ.get("PYGRID_SERVING_QUEUE", "64")),
            ),
            device=self.device,
        )
        # burn-rate SLOs over the bus histograms (telemetry/slo.py):
        # GET /telemetry/slo, the deep /healthz, and the dashboard table
        from pygrid_tpu_torch.telemetry.slo import SLOEngine, node_objectives

        self.slo = SLOEngine(node_objectives())
        #: failpoint (a storm harness's slow_node fault): seconds of
        #: artificial delay injected into the /data-centric/status/
        #: heartbeat — 0.0 (off) outside chaos drills
        self.chaos_status_delay_s = 0.0

    def all_stores(self):
        """The node's singleton store plus every live session worker's store —
        the scan surface for public discovery routes (/dataset-tags, /search),
        mirroring the reference's local_worker._objects scan
        (routes/data_centric/routes.py:171-189,253-273)."""
        stores = [self.local_worker.store]
        for session in self.sessions.all_sessions():
            if session._worker is not None:
                stores.append(session._worker.store)
        return stores


def create_app(
    node_id: str,
    database_url: str = ":memory:",
    kv_path: str | None = None,
    secret_key: str | None = None,
    network_url: str | None = None,
    num_replicas: int | None = None,
    strict_crypto_store: bool = False,
    device: str | torch.device = "cuda",
):
    """Build the node's application (reference create_app, __init__.py:131)
    on ``device`` (default ``"cuda"``)."""
    from pygrid_tpu_torch import telemetry, web
    from pygrid_tpu_torch.node import routes as R
    from pygrid_tpu_torch.node.ws import ws_handler

    ctx = NodeContext(
        node_id,
        database_url=database_url,
        kv_path=kv_path,
        secret_key=secret_key,
        network_url=network_url,
        num_replicas=num_replicas,
        strict_crypto_store=strict_crypto_store,
        device=device,
    )
    app = web.Application(
        client_max_size=256 * 1024 * 1024,
        middlewares=[telemetry.http_middleware()],
    )
    app["node"] = ctx

    async def _close_serving(app):
        # stop the generation engines' worker threads with the app —
        # queued requests fail typed instead of hanging on a dead server;
        # the engine joins its thread, a blocking wait kept off the loop
        import asyncio

        await asyncio.get_running_loop().run_in_executor(
            None, app["node"].serving.close
        )

    app.on_cleanup.append(_close_serving)

    async def _start_observability(app):
        import asyncio
        import logging

        from pygrid_tpu_torch.telemetry.bus import env_float

        # device-memory gauges sample on their own daemon thread;
        # the SLO engine snapshots on an asyncio cadence so burn-rate
        # windows have data even when no one scrapes. Clamped: 0 or a
        # negative knob would make the tick task a hot loop.
        telemetry.profiler.MEMORY.start()
        # periodic engine snapshots (flight recorder): crash dumps carry
        # a before-the-crash trajectory — cycle accumulators and serving
        # stats every ~10 s under load, nothing when idle
        telemetry.recorder.register_stats_provider(
            f"aggregation:{app['node'].id}", app["node"].fl.cycle_manager
        )
        telemetry.recorder.start_snapshots()
        interval = max(1.0, env_float("PYGRID_SLO_INTERVAL_S", 15.0))

        async def _tick():
            while True:
                await asyncio.sleep(interval)
                try:
                    # evaluate (not just tick): status transitions are
                    # detected here, so breach webhooks fire even when
                    # nobody is scraping /telemetry/slo — and the POST
                    # itself runs on the notifier's daemon thread, never
                    # this loop
                    app["node"].slo.evaluate()
                except Exception:  # noqa: BLE001 — cadence must survive
                    logging.getLogger(__name__).exception(
                        "SLO tick failed"
                    )

        app["slo_task"] = asyncio.get_running_loop().create_task(_tick())

    async def _stop_observability(app):
        import asyncio
        import contextlib

        task = app.get("slo_task")
        if task:
            task.cancel()
            # suppress the cancellation AND any stored exception: either
            # re-raising out of an on_cleanup hook would skip the sampler
            # release below (CancelledError is a BaseException)
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await task
        # the sampler/snapshotter stop() joins their threads (possibly
        # mid-sample) — blocking waits that must not run on the event loop
        await asyncio.get_running_loop().run_in_executor(
            None, telemetry.profiler.MEMORY.stop
        )
        await asyncio.get_running_loop().run_in_executor(
            None, telemetry.recorder.stop_snapshots
        )

    app.on_startup.append(_start_observability)
    app.on_cleanup.append(_stop_observability)
    app.router.add_get("/", ws_handler)  # WS upgrade or landing JSON
    R.register(app)
    return app
