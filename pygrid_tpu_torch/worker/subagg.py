"""The sub-aggregator — an edge fold between workers and the node.

The protocol plane's scaling wall is host-side report handling: every
worker report is a frame the node decodes and folds on its host, while
the device folds a whole round at once. A sub-aggregator absorbs the
``model-centric/report`` frames of a subtree of workers, folds each one
incrementally into a count-weighted partial sum straight from its
zero-copy wire view (``federated/partials.PartialFold``), and forwards
ONE ``model-centric/report-partial`` frame per flush — the node then
handles K/fanout frames per cycle instead of K, with validation of every
member's request key preserved (the partial carries the (worker_id,
request_key) list, so the tree adds no trust surface).

It speaks ``pygrid.wire.v2`` on both sides: downstream it serves the
same WS endpoint shape as the node (subprotocol negotiation, binary
msgpack twins, JSON fallback — a worker client cannot tell the
difference on the report path), upstream it is an ordinary wire-v2
client of the node. Deeper trees compose freely: a sub-aggregator also
accepts ``report-partial`` from downstream sub-aggregators and merges
them count-weighted.

Placement is the Network app's job (``/aggregation/placement``,
``network/aggregation.py``): the sub-aggregator registers itself (and
re-registers as a heartbeat) so the network can spread each node's
workers across its live sub-aggregators — and stop routing to one that
went silent, which is the mid-cycle failure story: an unflushed
subtree's workers were never marked reported, so their slots are still
open and the workers re-report directly (client fallback in
``client/fl_client.py``); the cycle's deadline closes any remainder.

SecAgg composes: masked reports are mod-2^32 sums, so the fold adds
masked uint32 vectors and forwards a masked partial — masks cancel at
the node's unmask round; the sub-aggregator never sees a plaintext diff
(strictly less than the node sees on the flat path).

The port's counterpart of :mod:`pygrid_tpu.worker.subagg`: the fold is the
port's host fold (``federated.partials.PartialFold`` through ``native``),
the upstream the port's ``GridWSClient(offer_wire_v2=True)``, the server
the port's :mod:`pygrid_tpu_torch.web` and the registration heartbeat its
async client. A fold's age is read from an injectable ``clock`` and a
successful registration sets ``SubAggregator.registered``, so a test drives
the tail flush and the heartbeat without sleeping.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

from pygrid_tpu_torch import telemetry
from pygrid_tpu_torch.federated.partials import PartialFold
from pygrid_tpu_torch.telemetry import bus as _bus
from pygrid_tpu_torch.utils import exceptions as E
from pygrid_tpu_torch.utils.codes import (
    CONTROL_EVENTS,
    CYCLE,
    MODEL_CENTRIC_FL_EVENTS,
    MSG_FIELD,
)

logger = logging.getLogger(__name__)

#: flush a fold once it holds this many leaf reports (the tree fanout) —
#: ``PYGRID_AGG_FANOUT`` tunes it per deployment
DEFAULT_FANOUT = 64

#: flush a non-empty fold after this many seconds even below fanout, so
#: the tail of a cycle never waits on stragglers that already reported
DEFAULT_FLUSH_INTERVAL_S = 0.5

#: node error fragments that mean "this FL process will NEVER accept a
#: partial" (robust/DP/hosted-avg-plan/secagg-mode mismatch) — the fold
#: key is poisoned so every later report bounces typed and the worker
#: client's direct fallback takes over; anything else (stale key, shape
#: mismatch) is per-report, not per-process
_INELIGIBLE_MARKERS = (
    "partial reports not accepted",
    "non-secagg process",
    "needs masked partials",
)

class _FoldSlot:
    """One fold key's live accumulation. The slot lock serializes the
    numpy accumulation PER KEY — the instance lock only guards the dict
    and counters, so concurrent FL processes fold in parallel across
    the executor threads. ``closed`` marks a fold claimed by a flush;
    a writer that loses that race retries against a fresh slot. Lock
    order is strictly instance-then-slot, never nested the other way."""

    __slots__ = ("fold", "first_at", "lock", "closed")

    def __init__(self, first_at: float) -> None:
        self.fold = PartialFold()
        self.first_at = first_at
        self.lock = threading.Lock()
        self.closed = False


class SubAggregator:
    """Fold state + upstream client for one sub-aggregator process."""

    def __init__(
        self,
        node_url: str,
        subagg_id: str | None = None,
        fanout: int | None = None,
        flush_interval: float | None = None,
        network_url: str | None = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        from pygrid_tpu_torch.client.base import GridWSClient
        from pygrid_tpu_torch.telemetry import bus

        #: what a fold's age is read from (injectable: a test ages a fold
        #: by advancing it, never by sleeping out ``flush_interval``)
        self.clock = clock
        #: set once a registration POST got the network's 200 (the
        #: heartbeat task's progress, observable without polling)
        self.registered = threading.Event()
        self.id = subagg_id or f"subagg-{uuid.uuid4().hex[:8]}"
        self.node_url = node_url.rstrip("/")
        self.network_url = network_url.rstrip("/") if network_url else None
        #: filled by the app factory / test harness once the listen
        #: address is known — what gets registered for placement
        self.address: str | None = None
        self.fanout = fanout or bus.env_int(
            "PYGRID_AGG_FANOUT", DEFAULT_FANOUT
        )
        self.flush_interval = (
            flush_interval
            if flush_interval is not None
            else bus.env_float(
                "PYGRID_AGG_FLUSH_INTERVAL_S", DEFAULT_FLUSH_INTERVAL_S
            )
        )
        self._upstream = GridWSClient(self.node_url, offer_wire_v2=True)
        self._lock = threading.Lock()
        #: fold group key -> live _FoldSlot. Grouped by the report's
        #: optional ``model`` hint so two FL processes through one
        #: sub-aggregator never mix sums; a shape mismatch inside a
        #: group still bounces typed.
        self._folds: dict[str, _FoldSlot] = {}
        #: fold keys the node has accepted a partial for / refused as a
        #: matter of process config. A key starts UNKNOWN: its first
        #: report is forwarded synchronously as a count-1 partial (legal,
        #: WIRE.md §3b) before the worker is acked — so an incompatible
        #: process can never silently eat a folded-but-unflushable report
        self._eligible: set[str] = set()
        self._ineligible: set[str] = set()
        self._reports = 0
        self._flushes = 0
        self._flush_errors = 0
        self._leaves_forwarded = 0
        telemetry.recorder.register_stats_provider(
            f"subagg:{self.id}", self
        )

    # ── downstream fold ─────────────────────────────────────────────────

    def handle_report(self, data: dict) -> None:
        """Fold one worker report (plain dense or SecAgg-masked). Typed
        errors propagate to the reporting worker, whose client then
        falls back to a direct node report."""
        diff = data.get(CYCLE.DIFF) or b""
        if isinstance(diff, str):
            from pygrid_tpu_torch.native import b64_decode_view

            try:
                diff = b64_decode_view(diff)
            except ValueError as err:
                raise E.PyGridError(
                    f"malformed report diff: {err}"
                ) from err
        elif not isinstance(diff, bytes):
            diff = bytes(diff)
        worker_id = data.get(MSG_FIELD.WORKER_ID)
        request_key = data.get(CYCLE.KEY)
        if not worker_id or not request_key:
            raise E.PyGridError("report needs worker_id and request_key")
        key = str(data.get(MSG_FIELD.MODEL) or "")
        with self._lock:
            proven = key in self._eligible
            poisoned = key in self._ineligible
        if poisoned:
            raise E.PyGridError(
                "this FL process does not accept partial reports — "
                f"report direct to the node at {self.node_url}"
            )
        if not proven:
            # eligibility probe: forward THIS report as a count-1
            # partial before acking, so a report is never folded into
            # a sum the node will refuse
            probe = PartialFold()
            try:
                probe.add_report(worker_id, request_key, bytes(diff))
            except ValueError as err:
                raise E.PyGridError(
                    f"malformed report payload: {err}"
                ) from err
            self._probe(key, probe)
            with self._lock:
                self._reports += 1
            telemetry.incr("subagg_reports_total", 1, kind="leaf")
            return
        self._fold_into_slot(
            key,
            lambda fold: fold.add_report(
                worker_id, request_key, bytes(diff)
            ),
        )
        telemetry.incr("subagg_reports_total", 1, kind="leaf")

    def handle_partial(self, data: dict) -> None:
        """Merge a DOWNSTREAM sub-aggregator's partial (trees deeper
        than two levels) — counts and weights add, entries concatenate."""
        diff = data.get(CYCLE.DIFF) or b""
        if isinstance(diff, str):
            diff = base64.b64decode(diff)
        elif not isinstance(diff, bytes):
            diff = bytes(diff)
        workers = data.get("workers")
        if not isinstance(workers, (list, tuple)):
            raise E.PyGridError("partial report needs a 'workers' list")
        entries = [(str(p[0]), str(p[1])) for p in workers]
        count = data.get("count", len(entries))
        if isinstance(count, bool) or not isinstance(count, int):
            raise E.PyGridError("partial count must be an integer")
        key = str(data.get(MSG_FIELD.MODEL) or "")
        with self._lock:
            proven = key in self._eligible
            poisoned = key in self._ineligible
        if poisoned:
            raise E.PyGridError(
                "this FL process does not accept partial reports — "
                f"report direct to the node at {self.node_url}"
            )
        weight_sum = data.get("weight_sum")
        masked = bool(data.get("masked"))
        if not proven:
            # same eligibility gate as leaf reports — a mid-tier
            # sub-aggregator buffering a downstream probe would prove
            # the key at the leaf WITHOUT the node ever having seen a
            # partial, and an incompatible process would then eat the
            # whole subtree silently at this tier's flush
            probe = PartialFold()
            try:
                probe.add_partial(
                    entries, bytes(diff), count,
                    weight_sum=weight_sum, masked=masked,
                )
            except ValueError as err:
                # malformed payloads (bad base64, size-mismatched bf16
                # accumulation) must bounce TYPED at the boundary
                raise E.PyGridError(
                    f"malformed partial payload: {err}"
                ) from err
            self._probe(key, probe)
            with self._lock:
                self._reports += 1
            telemetry.incr("subagg_reports_total", 1, kind="partial")
            return
        self._fold_into_slot(
            key,
            lambda fold: fold.add_partial(
                entries, bytes(diff), count,
                weight_sum=weight_sum, masked=masked,
            ),
        )
        telemetry.incr("subagg_reports_total", 1, kind="partial")

    def _fold_into_slot(self, key: str, add) -> None:
        """Fold one accepted report/partial into ``key``'s live slot
        (per-key locking; see _FoldSlot) and flush when it reaches the
        fanout. ``add`` raises typed on a report the fold cannot take —
        the slot is left untouched and the error propagates to the
        reporting peer."""
        slot = None
        ready = None
        while True:
            with self._lock:
                slot = self._folds.get(key)
                if slot is None:
                    slot = self._folds[key] = _FoldSlot(self.clock())
            with slot.lock:
                if slot.closed:
                    continue  # lost the race with a flush — fresh slot
                try:
                    add(slot.fold)
                except ValueError as err:
                    # the fold validates payload shape as it
                    # accumulates — a malformed diff bounces typed,
                    # slot untouched
                    raise E.PyGridError(
                        f"malformed report payload: {err}"
                    ) from err
                if slot.fold.count >= self.fanout:
                    slot.closed = True
                    ready = slot.fold
            break
        with self._lock:
            self._reports += 1
            if ready is not None and self._folds.get(key) is slot:
                del self._folds[key]
        if ready is not None:
            self._flush(ready)

    # ── upstream flush ──────────────────────────────────────────────────

    def flush_stale(self) -> None:
        """Flush every non-empty fold older than ``flush_interval`` —
        the cycle-tail path, driven by the app's timer task. Expired
        EMPTY slots (a first report that bounced typed) are reaped."""
        now = self.clock()
        with self._lock:
            candidates = [
                (key, slot)
                for key, slot in self._folds.items()
                if now - slot.first_at >= self.flush_interval
            ]
        self._drain(candidates)

    def flush_all(self) -> None:
        """Forward everything buffered right now (shutdown path)."""
        with self._lock:
            candidates = list(self._folds.items())
        self._drain(candidates)

    def _drain(self, candidates: list) -> None:
        ready: list[PartialFold] = []
        for key, slot in candidates:
            with slot.lock:
                if slot.closed:
                    continue
                slot.closed = True
                if slot.fold.count:
                    ready.append(slot.fold)
            with self._lock:
                if self._folds.get(key) is slot:
                    del self._folds[key]
        for fold in ready:
            self._flush(fold)

    def _probe(self, key: str, fold: PartialFold) -> None:
        """Eligibility probe for an unproven fold key: the FIRST report
        goes upstream synchronously as a count-1 partial (legal, WIRE.md
        §3b) BEFORE the worker is acked. Success proves the key — later
        reports buffer into real fanout-sized folds. A refusal that is a
        matter of process config (robust/DP/hosted-plan/secagg-mode
        mismatch) poisons the key so every later report bounces without
        an upstream round trip; either way the error propagates typed,
        the worker is never acked, and its client falls back to a
        direct node report — an incompatible process cannot silently
        eat a folded report."""
        err = self._flush(fold, raise_unreachable=True)
        with self._lock:
            if err is None:
                self._eligible.add(key)
            elif any(marker in err for marker in _INELIGIBLE_MARKERS):
                self._ineligible.add(key)
        if err is not None:
            raise E.PyGridError(err)

    def _flush(
        self, fold: PartialFold, raise_unreachable: bool = False
    ) -> str | None:
        """Forward one partial upstream. Returns the node's error string
        (None on acceptance). Transport failures are swallowed unless
        ``raise_unreachable`` — on the buffered path the workers were
        already acked, their node slots are still open, and the cycle
        deadline (plus direct re-reports) recovers the round; the probe
        path instead propagates so the worker retries direct."""
        blob, count, weight_sum = fold.to_report()
        t0 = time.perf_counter()
        outcome = "error"
        err: str | None = None
        try:
            response = self._upstream.send_msg_binary(
                MODEL_CENTRIC_FL_EVENTS.REPORT_PARTIAL,
                data={
                    "workers": [[w, k] for w, k in fold.entries],
                    "count": count,
                    "weight_sum": weight_sum,
                    "masked": bool(fold.masked),
                    CYCLE.DIFF: blob,
                },
            )
            data = response.get(MSG_FIELD.DATA, response)
            err = data.get("error")
            if err:
                with self._lock:
                    self._flush_errors += 1
                logger.warning(
                    "upstream rejected partial (%s workers): %s",
                    count, err,
                )
            else:
                outcome = "ok"
                with self._lock:
                    self._leaves_forwarded += count
        except Exception:  # noqa: BLE001 — node unreachable
            with self._lock:
                self._flush_errors += 1
            if raise_unreachable:
                raise
            logger.exception("upstream partial flush failed")
        finally:
            with self._lock:
                self._flushes += 1
            telemetry.observe(
                "subagg_flush_seconds", time.perf_counter() - t0
            )
            telemetry.incr(
                "aggregation_partials_total", 1, outcome=f"flush_{outcome}"
            )
            telemetry.recorder.note(
                "subagg.flush",
                subagg=self.id,
                workers=count,
                outcome=outcome,
            )
        return err

    # ── placement registration ──────────────────────────────────────────

    def registration(self) -> dict:
        return {
            "subagg-id": self.id,
            "subagg-address": self.address,
            "node-address": self.node_url,
        }

    def stats(self) -> dict:
        """Flight-recorder stats provider: the fold's live trajectory."""
        with self._lock:
            buffered = {
                key or "(default)": slot.fold.count
                for key, slot in self._folds.items()
            }
        return {
            "id": self.id,
            "reports": self._reports,
            "flushes": self._flushes,
            "flush_errors": self._flush_errors,
            "leaves_forwarded": self._leaves_forwarded,
            "buffered": buffered,
            "fanout": self.fanout,
        }

    def sever_upstream(self) -> None:
        """FAULT INJECTION (the JAX package's storm harness): drop the upstream WS
        connection as if the node-side link died mid-cycle. The next
        flush exercises the real reconnect path — this kills the socket,
        not the client, so no production code is bypassed."""
        self._upstream._drop_connection()

    def close(self) -> None:
        self.flush_all()
        self._upstream.close()


# ── the web app ────────────────────────────────────────────────────────


def create_subagg_app(
    node_url: str,
    subagg_id: str | None = None,
    fanout: int | None = None,
    flush_interval: float | None = None,
    network_url: str | None = None,
    register_interval: float = 5.0,
    clock: Callable[[], float] = time.monotonic,
):
    """A sub-aggregator WS server: same endpoint shape as the node's
    (subprotocol negotiation, binary twins, JSON fallback) but serving
    only the report plane — everything else answers a typed error
    directing the client at the node. ``clock`` ages the folds
    (:class:`SubAggregator`)."""
    from pygrid_tpu_torch import web
    from pygrid_tpu_torch.serde import (
        decode_frame,
        deserialize,
        encode_frame,
        offered_subprotocols,
        serialize,
        subprotocol_codec,
    )

    agg = SubAggregator(
        node_url,
        subagg_id=subagg_id,
        fanout=fanout,
        flush_interval=flush_interval,
        network_url=network_url,
        clock=clock,
    )
    # folds and upstream round trips are sync work — off the event loop,
    # mirroring the node's WS executor discipline
    executor = ThreadPoolExecutor(
        max_workers=_bus.env_int("PYGRID_AGG_THREADS", 8),
        thread_name_prefix="pygrid-subagg",
    )
    server_protocols = tuple(offered_subprotocols("auto"))

    _HANDLERS = {
        CONTROL_EVENTS.SOCKET_PING: lambda d: {MSG_FIELD.ALIVE: "True"},
        MODEL_CENTRIC_FL_EVENTS.REPORT: agg.handle_report,
        MODEL_CENTRIC_FL_EVENTS.REPORT_PARTIAL: agg.handle_partial,
    }

    def _dispatch(parsed: Any) -> dict:
        """One event in, one response envelope out (executor thread)."""
        if not isinstance(parsed, dict) or MSG_FIELD.TYPE not in parsed:
            return {"error": "sub-aggregator serves typed events only"}
        event = parsed[MSG_FIELD.TYPE]
        response: dict[str, Any] = {}
        handler = _HANDLERS.get(event)
        try:
            if handler is None:
                raise E.PyGridError(
                    f"event {event!r} is not served by a sub-aggregator "
                    f"— dial the node at {agg.node_url}"
                )
            out = handler(parsed.get(MSG_FIELD.DATA) or {})
            response = out if isinstance(out, dict) else {
                CYCLE.STATUS: "success"
            }
        except Exception as err:  # noqa: BLE001 — protocol boundary
            response = {"error": str(err)}
        envelope = {MSG_FIELD.TYPE: event, MSG_FIELD.DATA: response}
        if parsed.get(MSG_FIELD.REQUEST_ID):
            envelope[MSG_FIELD.REQUEST_ID] = parsed[MSG_FIELD.REQUEST_ID]
        return envelope

    def _process(payload: Any, wire_v2: bool, codec: str | None):
        """Unframe → dispatch → frame on the executor thread."""
        if isinstance(payload, str):
            try:
                envelope = _dispatch(json.loads(payload))
            except ValueError as err:
                envelope = {"error": f"bad JSON frame: {err}"}
            return json.dumps(envelope)
        try:
            blob = decode_frame(payload) if wire_v2 else payload
            envelope = _dispatch(deserialize(blob))
        except Exception as err:  # noqa: BLE001 — peer bytes
            envelope = {"error": f"bad report frame: {err}"}
        out = serialize(envelope)
        return encode_frame(out, codec) if wire_v2 else out

    async def ws_handler(request: web.Request) -> web.StreamResponse:
        if request.headers.get("Upgrade", "").lower() != "websocket":
            return web.json_response(
                {"subagg_id": agg.id, "message": "pygrid-tpu sub-aggregator",
                 "node": agg.node_url, "stats": agg.stats()}
            )
        ws = web.WebSocketResponse(
            max_msg_size=256 * 1024 * 1024, protocols=server_protocols
        )
        await ws.prepare(request)
        wire_v2, codec = subprotocol_codec(ws.ws_protocol)
        loop = asyncio.get_running_loop()
        async for msg in ws:
            if msg.type not in (web.WSMsgType.TEXT, web.WSMsgType.BINARY):
                continue
            response = await loop.run_in_executor(
                executor, _process, msg.data, wire_v2, codec
            )
            try:
                if isinstance(response, (bytes, bytearray)):
                    await ws.send_bytes(bytes(response))
                else:
                    await ws.send_str(response)
            except (ConnectionError, RuntimeError):
                break
        return ws

    app = web.Application()
    app["subagg"] = agg
    app.router.add_get("/", ws_handler)

    async def _register_once() -> None:
        if not (agg.network_url and agg.address):
            return
        try:
            timeout = web.ClientTimeout(total=5)
            async with web.ClientSession(timeout=timeout) as session:
                async with session.post(
                    agg.network_url + "/aggregation/register",
                    json=agg.registration(),
                ) as resp:
                    await resp.read()
            if resp.status == 200:
                agg.registered.set()
        except Exception:  # noqa: BLE001 — network down ≠ fold down
            logger.warning("sub-aggregator registration failed", exc_info=True)

    async def _background(app_) -> None:
        loop = asyncio.get_running_loop()
        last_register = 0.0
        try:
            while True:
                now = time.monotonic()
                if now - last_register >= register_interval:
                    await _register_once()
                    last_register = now
                await loop.run_in_executor(executor, agg.flush_stale)
                # wake for whichever comes first, the next stale check or
                # the next heartbeat (a long flush interval must not
                # stretch the registration cadence)
                await asyncio.sleep(
                    max(min(agg.flush_interval / 2, register_interval), 0.05)
                )
        except asyncio.CancelledError:
            pass

    async def _start(app_) -> None:
        # periodic engine snapshots: the fold's trajectory (buffered
        # counts, flush errors) rides the flight-recorder ring so a
        # crash dump shows what the subtree was doing before it died
        telemetry.recorder.start_snapshots()
        app_["subagg_task"] = asyncio.get_running_loop().create_task(
            _background(app_)
        )

    async def _stop(app_) -> None:
        task = app_.get("subagg_task")
        if task:
            task.cancel()
        await asyncio.get_running_loop().run_in_executor(
            executor, agg.close
        )
        await asyncio.get_running_loop().run_in_executor(
            executor, telemetry.recorder.stop_snapshots
        )
        executor.shutdown(wait=False)

    app.on_startup.append(_start)
    app.on_cleanup.append(_stop)
    return app
