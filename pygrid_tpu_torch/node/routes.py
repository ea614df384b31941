"""Node HTTP routes: model-centric, data-centric, users.

Parity surface: reference ``apps/node/src/app/main/routes/model_centric/
routes.py`` (cycle-request/speed-test/report/get-protocol/get-model/get-plan/
authenticate/retrieve-model — see SURVEY.md §2.1) and
``routes/data_centric/routes.py`` (models/detailed-models-list/identity/
status/workers/serve-model/dataset-tags/search-encrypted-models/search), plus
the users HTTP CRUD. Status codes mirror the reference: 400 bad request,
401 invalid request key, 404 model missing, 500 otherwise.

The port's counterpart of :mod:`pygrid_tpu.node.routes`: the same 51
routes, JSON bodies and status codes, served by the port's own
:mod:`pygrid_tpu_torch.web`.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
from typing import Any

from pygrid_tpu_torch import telemetry, web
from pygrid_tpu_torch.node import NodeContext, __version__
from pygrid_tpu_torch.node.events import (
    Connection,
    authenticate as ws_authenticate,
    cycle_request as ws_cycle_request,
    report as ws_report,
    _USER_HANDLERS,
)
from pygrid_tpu_torch.plans.plan import Plan
from pygrid_tpu_torch.utils import exceptions as E
from pygrid_tpu_torch.utils.codes import MSG_FIELD

logger = logging.getLogger(__name__)

SPEED_TEST_SAMPLE_BYTES = 64 * 1024 * 1024  # reference: 64MB, routes.py:80-83


def _ctx(request: web.Request) -> NodeContext:
    return request.app["node"]


async def _off_loop(fn, *args):
    """Run a blocking callable on the default executor — the HTTP routes'
    door for sync WS-handler bridges and model-scale serde/base64 work
    (gridlint GL3: one megabyte decode on the loop stalls every socket
    the process serves). The caller's contextvars are carried across:
    the telemetry middleware's trace span lives in a contextvar, and an
    executor thread does not inherit it — without the copy, a bridged
    ``report`` would record no trace on the cycle timeline."""
    import asyncio
    import contextvars

    ctx = contextvars.copy_context()
    return await asyncio.get_running_loop().run_in_executor(
        None, lambda: ctx.run(fn, *args)
    )


def _json_error(err: Exception, status: int) -> web.Response:
    return web.json_response({"error": str(err)}, status=status)


def _status_for(err: Exception) -> int:
    if isinstance(err, E.ServerBusyError):
        return 503  # backpressure: retryable, not a client defect
    if isinstance(err, E.InvalidRequestKeyError):
        return 401
    if isinstance(
        err,
        (
            E.ModelNotFoundError,
            E.CheckPointNotFound,
            E.FLProcessNotFoundError,
        ),
    ):
        return 404
    if isinstance(err, E.PyGridError):
        return 400
    return 500


# ── model-centric ────────────────────────────────────────────────────────────


async def mc_cycle_request(request: web.Request) -> web.Response:
    """HTTP mirror of the WS cycle-request (reference routes.py:37-60)."""
    try:
        body = json.loads(await request.text())
    except (json.JSONDecodeError, UnicodeDecodeError) as err:
        return _json_error(err, 400)
    response = await _off_loop(
        ws_cycle_request,
        _ctx(request), {MSG_FIELD.DATA: body}, Connection(_ctx(request)),
    )
    return web.json_response(response[MSG_FIELD.DATA])


async def mc_speed_test(request: web.Request) -> web.Response:
    """(reference routes.py:62-99) download sample / ping / upload sink."""
    worker_id = request.query.get("worker_id")
    random = request.query.get("random")
    is_ping = request.query.get("is_ping")
    if not worker_id or not random:
        return _json_error(E.PyGridError(""), 400)
    if request.method == "GET" and is_ping is None:
        try:
            size = int(request.query.get("size", SPEED_TEST_SAMPLE_BYTES))
        except ValueError as err:
            return _json_error(err, 400)
        # unauthenticated endpoint: cap at the reference's 64MB sample, and
        # stream it in chunks — materializing the full sample per request
        # would let anonymous callers burn 64MB of RSS each
        size = max(0, min(size, SPEED_TEST_SAMPLE_BYTES))
        response = web.StreamResponse(
            headers={
                "Content-Type": "application/octet-stream",
                "Content-Length": str(size),
            }
        )
        await response.prepare(request)
        chunk = b"x" * min(size, 1 << 20)
        sent = 0
        while sent < size:
            n = min(size - sent, len(chunk))
            await response.write(chunk[:n])
            sent += n
        await response.write_eof()
        return response
    if request.method == "POST":
        await request.read()  # upload sink
    return web.json_response({})


async def mc_report(request: web.Request) -> web.Response:
    try:
        # an FL report body is megabytes of base64 diff — parsing it is
        # CPU work the loop must not pay (same reasoning as _off_loop)
        body = await _off_loop(json.loads, await request.text())
    except (json.JSONDecodeError, UnicodeDecodeError) as err:
        return _json_error(err, 400)
    response = await _off_loop(
        ws_report,
        _ctx(request), {MSG_FIELD.DATA: body}, Connection(_ctx(request)),
    )
    return web.json_response(response[MSG_FIELD.DATA])


async def mc_authenticate(request: web.Request) -> web.Response:
    try:
        body = json.loads(await request.text())
    except (json.JSONDecodeError, UnicodeDecodeError) as err:
        return _json_error(err, 400)
    response = await _off_loop(
        ws_authenticate,
        _ctx(request), {MSG_FIELD.DATA: body}, Connection(_ctx(request)),
    )
    return web.json_response(response[MSG_FIELD.DATA])


def _require_query(request: web.Request, *names: str) -> list[str]:
    """Explicit 400 bodies for absent params (the reference's download
    routes answer with named missing-key messages, routes.py:163-250, not
    a generic 401)."""
    missing = [n for n in names if not request.query.get(n)]
    if missing:
        raise E.MissingRequestKeyError(
            f"missing query parameter(s): {', '.join(missing)}"
        )
    return [request.query[n] for n in names]


def _validated_cycle(ctx: NodeContext, request: web.Request, fl_process_id: int):
    """request_key gate shared by the three download routes
    (reference routes.py:163-250). Returns the validated cycle so
    callers can attribute wire bytes to its timeline."""
    worker_id, request_key = _require_query(request, "worker_id", "request_key")
    cycle = ctx.fl.cycle_manager.last(fl_process_id)
    worker = ctx.fl.worker_manager.get(id=worker_id)
    ctx.fl.cycle_manager.validate(worker.id, cycle.id, request_key)
    return cycle


async def mc_get_model(request: web.Request) -> web.Response:
    ctx = _ctx(request)
    try:
        model_id = int(_require_query(request, "model_id")[0])
        model = ctx.fl.model_manager.get(id=model_id)
        cycle = _validated_cycle(ctx, request, model.fl_process_id)
        # ?codec=zlib|zstd → the wire-v2 frame envelope, compressed once
        # per checkpoint (blob cache) and unwrapped client-side with
        # decode_frame. The response header is the client's only signal —
        # an old node ignores the param and serves raw, so absence of the
        # header means raw bytes.
        from pygrid_tpu_torch.serde import available_codecs

        codec = request.query.get("codec")
        codec = codec if codec in available_codecs() else None
        blob = ctx.fl.model_manager.load_encoded(
            model_id, precision=request.query.get("precision"), codec=codec
        )
        telemetry.timeline.add_bytes(
            cycle.id, "download", codec or "http", len(blob)
        )
        telemetry.incr(
            "model_download_bytes_total", len(blob), codec=codec or "http"
        )
        headers = {"X-PyGrid-Wire": "v2-frame"} if codec else {}
        return web.Response(
            body=blob,
            content_type="application/octet-stream",
            headers=headers,
        )
    except Exception as err:  # noqa: BLE001 — HTTP boundary
        return _json_error(err, _status_for(err))


async def mc_get_plan(request: web.Request) -> web.Response:
    ctx = _ctx(request)
    try:
        plan_id = int(_require_query(request, "plan_id")[0])
        variant = request.query.get("receive_operations_as", "list")
        plan = ctx.fl.plan_manager.get(id=plan_id, is_avg_plan=False)
        _validated_cycle(ctx, request, plan.fl_process_id)
        blob = ctx.fl.plan_manager.get_variant(plan_id, variant)
        return web.Response(
            body=blob, content_type="application/octet-stream"
        )
    except Exception as err:  # noqa: BLE001 — HTTP boundary
        return _json_error(err, _status_for(err))


async def mc_get_protocol(request: web.Request) -> web.Response:
    ctx = _ctx(request)
    try:
        protocol_id = int(_require_query(request, "protocol_id")[0])
        protocol = ctx.fl.protocol_manager.get(id=protocol_id)
        _validated_cycle(ctx, request, protocol.fl_process_id)
        return web.Response(
            body=protocol.value, content_type="application/octet-stream"
        )
    except Exception as err:  # noqa: BLE001 — HTTP boundary
        return _json_error(err, _status_for(err))


async def mc_req_join(request: web.Request) -> web.Response:
    """Probabilistic cycle-admission decision (reference routes.py:287-468,
    the ``/req-join`` Poisson worker-selection endpoint). Accepts by model
    name+version (or fl_process id), worker speeds and id; returns
    ``{"status": "accepted"|"rejected"}`` with 200/400 like the reference."""
    import datetime as dt

    from pygrid_tpu_torch.federated.selection import should_admit

    ctx = _ctx(request)
    try:
        q = request.query
        if q.get("model_id"):
            process = ctx.fl.process_manager.first(id=int(q["model_id"]))
        else:
            filters: dict[str, Any] = {"name": q.get("name")}
            if q.get("version"):
                filters["version"] = q["version"]
            process = ctx.fl.process_manager.first(**filters)
        cycle = ctx.fl.cycle_manager.last(process.id)
        server_config = ctx.fl.process_manager.get_configs(
            fl_process_id=process.id, is_server_config=True
        )
        worker_id = q.get("worker_id", "")
        time_left = None
        if cycle.end is not None:
            now = dt.datetime.now(dt.timezone.utc).replace(tzinfo=None)
            time_left = (cycle.end - now).total_seconds()
        decision = should_admit(
            server_config=server_config,
            cycle_sequence=cycle.sequence,
            cycle_time_left=time_left,
            workers_in_cycle=ctx.fl.cycle_manager.workers_in_cycle(cycle.id),
            already_in_cycle=ctx.fl.cycle_manager.is_assigned(
                cycle.id, worker_id
            ),
            last_participation=ctx.fl.cycle_manager.last_participation(
                process.id, worker_id
            ),
            up_speed=float(q.get("up_speed", 0)),
            down_speed=float(q.get("down_speed", 0)),
            # observed join rate; the reference hard-codes 5/unit-time
            # (routes.py:384) — here overridable per request for ops/tests
            request_rate=float(q.get("request_rate", 5.0)),
        )
        status = "accepted" if decision.accepted else "rejected"
        return web.json_response(
            {"status": status, "reason": decision.reason},
            status=200 if decision.accepted else 400,
        )
    except (ValueError, TypeError) as err:  # malformed query params
        return _json_error(err, 400)
    except Exception as err:  # noqa: BLE001 — HTTP boundary
        return _json_error(err, _status_for(err))


async def mc_processes(request: web.Request) -> web.Response:
    """Hosted FL processes with cycle progress — feeds the dashboard's
    FL section (no reference analog; its dashboard lists only
    data-centric models)."""
    ctx = _ctx(request)
    try:
        out = []
        for process in ctx.fl.process_manager.get():
            entry = {
                "name": process.name,
                "version": process.version,
                "cycles_completed": ctx.fl.cycle_manager.count_cycles(
                    fl_process_id=process.id, is_completed=True
                ),
                "cycles_total": ctx.fl.cycle_manager.count_cycles(
                    fl_process_id=process.id
                ),
            }
            # latest aggregated metrics embedded so the dashboard poll is
            # one request, not one per process per refresh
            latest = ctx.fl.cycle_manager.latest_metrics(process.id)
            if latest:
                entry["latest_metrics"] = latest
            out.append(entry)
        return web.json_response({"processes": out})
    except Exception as err:  # noqa: BLE001 — HTTP boundary
        return _json_error(err, _status_for(err))


async def mc_cycle_metrics(request: web.Request) -> web.Response:
    """Per-cycle sample-weighted training metrics reported by workers
    (this framework's extension — the reference has no structured
    metrics, SURVEY §5.5; `/metrics` is the Prometheus exposition, this
    is the FL-semantic curve)."""
    ctx = _ctx(request)
    try:
        filters: dict[str, Any] = {"name": request.query.get("name")}
        if request.query.get("version"):
            filters["version"] = request.query.get("version")
        process = ctx.fl.process_manager.first(**filters)
        return web.json_response(
            {"cycles": ctx.fl.cycle_manager.cycle_metrics(process.id)}
        )
    except Exception as err:  # noqa: BLE001 — HTTP boundary
        return _json_error(err, _status_for(err))


async def mc_retrieve_model(request: web.Request) -> web.Response:
    """Public checkpoint download by name/version/checkpoint alias or number
    (reference routes.py:471-516)."""
    ctx = _ctx(request)
    try:
        filters: dict[str, Any] = {"name": request.query.get("name")}
        if request.query.get("version"):
            filters["version"] = request.query.get("version")
        process = ctx.fl.process_manager.first(**filters)
        model = ctx.fl.model_manager.get(fl_process_id=process.id)
        checkpoint_query: dict[str, Any] = {"model_id": model.id}
        checkpoint = request.query.get("checkpoint")
        if checkpoint:
            if checkpoint.isnumeric():
                checkpoint_query["number"] = int(checkpoint)
            else:
                checkpoint_query["alias"] = checkpoint
        else:
            checkpoint_query["alias"] = "latest"
        record = ctx.fl.model_manager.load(**checkpoint_query)
        return web.Response(
            body=record.value, content_type="application/octet-stream"
        )
    except Exception as err:  # noqa: BLE001 — HTTP boundary
        return _json_error(err, _status_for(err))


# ── telemetry ────────────────────────────────────────────────────────────────


async def telemetry_cycles(request: web.Request) -> web.Response:
    """Newest-first summaries of recent FL cycles (phase durations,
    report counts, stragglers) — the dashboard's poll and the operator's
    index into the per-cycle detail route."""
    ctx = _ctx(request)
    try:
        limit = int(request.query.get("limit", 20))
    except ValueError as err:
        return _json_error(err, 400)
    return web.json_response(
        {"cycles": ctx.fl.cycle_manager.recent_cycles(max(1, limit))}
    )


async def telemetry_cycle_detail(request: web.Request) -> web.Response:
    """One cycle's full round timeline: per-phase durations, per-worker
    report latency/bytes/codec, wire bytes per codec, the trace ids that
    stitch it to client spans, and straggler counts."""
    ctx = _ctx(request)
    try:
        cycle_id = int(request.match_info["id"])
    except ValueError as err:
        return _json_error(err, 400)
    snap = ctx.fl.cycle_manager.cycle_timeline(cycle_id)
    if snap is None:
        return web.json_response(
            {"error": f"unknown cycle {cycle_id}"}, status=404
        )
    return web.json_response(snap)


async def telemetry_events(request: web.Request) -> web.Response:
    """The ring buffer's most recent structured events (spans included) —
    the low-tech trace viewer: filter by ?event= and ?trace_id=."""
    try:
        limit = int(request.query.get("limit", 200))
    except ValueError as err:
        return _json_error(err, 400)
    # filter BEFORE the tail-limit: a trace's spans must be findable even
    # when newer unrelated events have pushed them past `limit`
    events = telemetry.events(event=request.query.get("event"))
    trace_id = request.query.get("trace_id")
    if trace_id:
        events = [e for e in events if e.get("trace_id") == trace_id]
    return web.json_response(
        {"events": events[-max(1, min(limit, 2048)):]}
    )


# ── data-centric ─────────────────────────────────────────────────────────────


def _dc_session(request: web.Request):
    ctx = _ctx(request)
    token = request.headers.get("token") or request.query.get("token")
    session = ctx.sessions.by_token(token)
    if session is None:
        raise E.AuthorizationError("authentication required")
    return session


async def dc_models(request: web.Request) -> web.Response:
    """(reference routes.py: /models/) public list of hosted model ids."""
    ctx = _ctx(request)
    return web.json_response(
        {"success": True, "models": ctx.models.models(ctx.local_worker.id)}
    )


async def dc_detailed_models(request: web.Request) -> web.Response:
    ctx = _ctx(request)
    out = []
    for model_id in ctx.models.models(ctx.local_worker.id):
        hosted = ctx.models.get(ctx.local_worker.id, model_id)
        out.append(hosted.flags())
    return web.json_response({"success": True, "models": out})


async def dc_identity(request: web.Request) -> web.Response:
    return web.json_response(
        {"identity": _ctx(request).id, "version": __version__}
    )


async def dc_status(request: web.Request) -> web.Response:
    import os

    from pygrid_tpu_torch.utils.profiling import stats

    # failpoint (a storm harness's slow_node fault): the monitor's HTTP
    # heartbeat fallback lands here, so an injected delay is seen by the
    # network as real RTT degradation — 0.0 in production
    delay = getattr(_ctx(request), "chaos_status_delay_s", 0.0)
    if delay:
        await asyncio.sleep(delay)
    return web.json_response(
        {
            "status": "OK",
            "timings": stats.snapshot(),
            # self-reported placement (reference resolves this via geo-IP,
            # worker.py:47-61; zero-egress deployments set NODE_LOCATION)
            "location": os.environ.get("NODE_LOCATION"),
        }
    )


async def metrics(request: web.Request) -> web.Response:
    """Prometheus text exposition of the node's state and timings — beyond
    parity: the reference has no structured metrics at all (SURVEY §5.5,
    its observability is the 15s monitor JSON). Scrape ``/metrics``."""
    ctx = _ctx(request)
    from pygrid_tpu_torch.utils.metrics import Exposition
    from pygrid_tpu_torch.utils.profiling import stats

    exp = Exposition()
    fl = ctx.fl
    exp.counter("workers_total", fl.worker_manager.count(),
                "FL workers ever registered")
    exp.gauge("fl_processes", fl.process_manager.count(),
              "hosted FL processes")
    exp.counter("cycles_total", fl.cycle_manager.count_cycles(),
                "cycles created")
    exp.gauge(
        "cycles_open",
        fl.cycle_manager.count_cycles(is_completed=False),
        "cycles awaiting diffs",
    )
    exp.counter(
        "worker_diffs_total",
        fl.cycle_manager.count_worker_cycles(is_completed=True),
        "diffs received",
    )
    exp.gauge("hosted_models", len(ctx.models.models(ctx.local_worker.id)),
              "data-centric hosted models")
    exp.gauge("store_objects", sum(len(s) for s in ctx.all_stores()),
              "objects across tensor stores")
    for name, rec in stats.snapshot().items():
        labels = {"name": name}
        exp.counter("timing_seconds_total", rec["total_s"],
                    "cumulative seconds per timed section", labels)
        exp.counter("timing_invocations_total", rec["count"],
                    "invocations per timed section", labels)
    # serving engines: point-in-time gauges (the counters/histograms —
    # TTFT, per-token latency, occupancy, compiles — ride the bus below)
    for eng in ctx.serving.stats():
        labels = {"model": eng["model_id"]}
        exp.gauge("serving_queue_depth", eng["queue_depth"],
                  "generation rows waiting for a slot", labels)
        exp.gauge("serving_live_slots", eng["live_slots"],
                  "generation slots decoding right now", labels)
        exp.gauge("serving_max_slots", eng["max_slots"],
                  "generation slots in the shared KV cache", labels)
        if eng.get("paged"):
            # block-pool occupancy: free / used (held by live requests,
            # INCLUDING cached blocks they share) / cached (reclaimable
            # cache-only) — the three sum to the pool, and peak
            # shared-prefix load reads as USED, not as cache bloat
            total = eng["kv_blocks_total"]
            free = eng["kv_blocks_free"]
            idle_cached = eng["kv_blocks_idle_cached"]
            for state, value in (
                ("free", free),
                ("used", max(0, total - free - idle_cached)),
                ("cached", idle_cached),
            ):
                exp.gauge(
                    "serving_kv_blocks", value,
                    "paged KV pool blocks, by state (free/used/cached)",
                    {**labels, "state": state},
                )
            exp.gauge(
                "serving_kv_block_tokens", eng["block_size"],
                "tokens per paged KV block", labels,
            )
            exp.gauge(
                "serving_kv_fragmentation", eng["kv_fragmentation"],
                "allocated-but-unwritten fraction of live KV pages",
                labels,
            )
    # the telemetry bus: event counters + every histogram family
    # (request latency by route, frame decode time, report latency,
    # cycle phases, wire bytes by codec, serde tensor copies)
    telemetry.export(exp)
    # device-memory gauges (background-sampled; absent on CPU backends)
    # and the SLO compliance/burn gauges
    telemetry.profiler.export_device_memory(exp)
    ctx.slo.export(exp)
    return web.Response(
        text=exp.render(), content_type="text/plain", charset="utf-8"
    )


async def dc_workers(request: web.Request) -> web.Response:
    ctx = _ctx(request)
    workers = [w.id for w in ctx.fl.worker_manager.query()]
    return web.json_response({"workers": workers})


async def dc_download_model(request: web.Request) -> web.Response:
    """GET twin of serve-model: the hosted blob back out, gated on the
    model's ``allow_download`` flag and a session token (the flag the
    reference's ModelStorage carries for exactly this purpose)."""
    ctx = _ctx(request)
    try:
        _dc_session(request)
        model_id = _require_query(request, "model_id")[0]
        hosted = ctx.models.get(ctx.local_worker.id, model_id)
        if not hosted.allow_download:
            raise E.AuthorizationError(
                "You're not allowed to download this model."
            )
        from pygrid_tpu_torch.serde import serialize

        blob = hosted.serialized
        if blob is None:
            # serializing a model-scale payload on the event loop would
            # stall every other socket (gridlint GL303)
            blob = await _off_loop(serialize, hosted.model)
        return web.Response(
            body=blob, content_type="application/octet-stream"
        )
    except Exception as err:  # noqa: BLE001 — HTTP boundary
        return _json_error(err, _status_for(err))


async def dc_serve_model(request: web.Request) -> web.Response:
    """(reference routes.py:128-169) host a model over HTTP; multipart for
    big payloads or JSON with base64 body."""
    ctx = _ctx(request)
    try:
        # the cheap session gate FIRST: an anonymous caller must not
        # burn executor CPU decoding a multi-megabyte body
        _dc_session(request)

        def _save(fields: dict, blob: bytes):
            return ctx.models.save(
                ctx.local_worker.id,
                blob,
                fields.get("model_id"),
                allow_download=str(fields.get("allow_download")) == "True",
                allow_remote_inference=str(
                    fields.get("allow_remote_inference")
                )
                == "True",
                mpc=str(fields.get("mpc")) == "True",
            )

        if request.content_type.startswith("multipart/"):
            reader = await request.multipart()
            fields: dict[str, Any] = {}
            async for part in reader:
                if part.name == "model":
                    fields["model"] = await part.read(decode=False)
                else:
                    fields[part.name] = (await part.text())
            blob = bytes(fields.pop("model"))
            result = await _off_loop(_save, fields, blob)
        else:
            # JSON parse of the megabyte body, base64 decode of its
            # model field and the persist are all milliseconds-per-
            # megabyte of CPU (gridlint GL303) — ONE executor hop for
            # the lot, not three round-trips
            text = await request.text()

            def _decode_and_save():
                fields = json.loads(text)
                blob = base64.b64decode(fields.pop("model"))
                return _save(fields, blob)

            result = await _off_loop(_decode_and_save)
        return web.json_response(result)
    except Exception as err:  # noqa: BLE001 — HTTP boundary
        return _json_error(err, _status_for(err))


async def dc_run_generation(request: web.Request) -> web.Response:
    """HTTP door into the continuous-batching generation engine
    (docs/SERVING.md) — a genuinely async enqueue-and-await: the
    request's rows join the model's batch and the event loop awaits the
    engine future directly, so a slow generation holds no executor
    thread at all. Body mirrors the WS ``run-generation`` event
    (``model_id``, base64 ``data``, ``n_new``, ``temperature``,
    ``seed``); session token via the ``token`` header. A full queue is
    503, validation defects are 400 — same typed messages as the WS
    twin (both doors share ``_prepare_generation``)."""
    import asyncio

    from pygrid_tpu_torch.node.events import _prepare_generation

    ctx = _ctx(request)
    try:
        _dc_session(request)
        body = json.loads(await request.text())
        # validation deserializes the (possibly large) prompt blob —
        # off the event loop like every other blocking handler
        prep = await _off_loop(_prepare_generation, ctx, body)
        if isinstance(prep, dict):
            return web.json_response(prep, status=400)
        hosted, prompt, n_new, temperature, seed = prep
        engine = ctx.serving.engine_for(
            str(body[MSG_FIELD.MODEL_ID]), hosted
        )
        future = engine.enqueue(prompt, n_new, temperature, seed)
        tokens = await asyncio.wait_for(
            asyncio.wrap_future(future),
            timeout=engine.config.default_timeout_s,
        )
        return web.json_response(
            {"success": True, "tokens": tokens.tolist()}
        )
    except asyncio.TimeoutError:
        return _json_error(
            E.PyGridError("generation timed out awaiting the batch engine"),
            504,
        )
    except (json.JSONDecodeError, ValueError, TypeError) as err:
        # same client-defect class the WS door answers typed (e.g.
        # n_new="abc", undecodable data blob) — a 400, never a 500
        return _json_error(err, 400)
    except Exception as err:  # noqa: BLE001 — HTTP boundary
        return _json_error(err, _status_for(err))


async def telemetry_serving(request: web.Request) -> web.Response:
    """Per-engine serving gauges (queue depth, live slots, totals) —
    the dashboard's poll; histograms (TTFT, per-token latency, batch
    occupancy) are on /metrics."""
    return web.json_response({"engines": _ctx(request).serving.stats()})


async def telemetry_programs(request: web.Request) -> web.Response:
    """Program introspection: every serving program's key, bucket,
    first-call ms, hit count AND its cost (flops / bytes accessed,
    counted by ``telemetry.profiler`` — rows ranked by total bytes
    accessed, i.e. device pressure, not just wall-clock), plus the
    latest device-memory sample. ``?cost=0`` (or PYGRID_PROFILER_COST=off)
    skips the cost pass; the first costed snapshot runs off the event
    loop so it cannot stall the sockets."""
    include_cost = request.query.get("cost", "1") not in ("0", "false")
    if include_cost:
        programs = await _off_loop(
            lambda: telemetry.profiler.programs_snapshot(include_cost=True)
        )
    else:
        programs = telemetry.profiler.programs_snapshot()
    return web.json_response(
        {
            "programs": programs,
            "device_memory": telemetry.profiler.MEMORY.latest(),
            "device_memory_age_s": telemetry.profiler.MEMORY.age_s(),
            "profiler_enabled": telemetry.profiler.enabled(),
            "cost_enabled": telemetry.profiler.cost_enabled(),
        }
    )


async def telemetry_slo(request: web.Request) -> web.Response:
    """Burn-rate SLO evaluation (telemetry/slo.py): per objective the
    compliance, per-window burn rates, and ok/warn/breach status — the
    dashboard SLO table and any alerting glue poll this."""
    return web.json_response({"slo": _ctx(request).slo.evaluate()})


async def telemetry_dump(request: web.Request) -> web.Response:
    """Operator-triggered flight-recorder crash dump: writes the
    redacted JSON black box (ring + bus events + engine snapshots) and
    returns its path. Session-token gated (a dump is work + disk, and
    crash evidence must not be evictable by anonymous callers); always
    writes once authorized (bypasses the per-reason rate limit); the
    file write runs off the event loop."""
    ctx = _ctx(request)
    try:
        _dc_session(request)
    except Exception as err:  # noqa: BLE001 — HTTP boundary
        return _json_error(err, _status_for(err))
    path = await _off_loop(
        lambda: telemetry.recorder.dump(
            "operator", snapshot={"serving": ctx.serving.stats()},
            force=True,
        )
    )
    return web.json_response({"success": True, "path": path})


async def healthz(request: web.Request) -> web.Response:
    """Shallow by default (the process answers → 200, for LB probes);
    ``?deep=1`` evaluates the SLO engine and serving state and answers
    503 when any objective is in breach — the page-someone signal."""
    if request.query.get("deep") not in ("1", "true", "yes"):
        return web.json_response({"status": "ok"})
    ctx = _ctx(request)
    rows = ctx.slo.evaluate()
    breaches = [r["name"] for r in rows if r["status"] == "breach"]
    body = {
        "status": "breach" if breaches else "ok",
        "breaches": breaches,
        "slo": rows,
        "serving": ctx.serving.stats(),
    }
    return web.json_response(body, status=503 if breaches else 200)


async def dc_dataset_tags(request: web.Request) -> web.Response:
    """(reference routes.py:171-189) all tags across the node's store."""
    ctx = _ctx(request)
    tags: set[str] = set()
    for store in ctx.all_stores():
        tags |= store.tags()
    return web.json_response(sorted(tags))


def _find_shared_tensors(value: Any) -> list[Any]:
    """Descend a hosted model / plan state to its shared tensors — live
    AdditiveSharingTensors or SharedTensorRef wiring metadata; both carry
    ``owners``/``crypto_provider_id``. (Reference routes.py:192-250 walks
    Plan.state tensor chains the same way.)"""
    found = []
    if hasattr(value, "owners") and hasattr(value, "crypto_provider_id"):
        found.append(value)
    elif isinstance(value, Plan) and value.state is not None:
        for t in value.state.tensors():
            found.extend(_find_shared_tensors(t))
    elif isinstance(value, (list, tuple)):
        for v in value:
            found.extend(_find_shared_tensors(v))
    return found


async def dc_search_encrypted_models(request: web.Request) -> web.Response:
    ctx = _ctx(request)
    try:
        body = json.loads(await request.text())
        model_id = body.get("model_id")
        hosted = ctx.models.get(ctx.local_worker.id, model_id)
        if not hosted.mpc:
            raise E.ModelNotFoundError()
        shared = _find_shared_tensors(hosted.model)
        if not shared:
            raise E.ModelNotFoundError()
        workers = sorted({o for t in shared for o in t.owners})
        providers = sorted(
            {
                t.crypto_provider_id
                for t in shared
                if t.crypto_provider_id is not None
            }
        )
        return web.json_response(
            {
                "success": True,
                "workers": workers,
                "crypto_provider": providers,
            }
        )
    except Exception as err:  # noqa: BLE001 — HTTP boundary
        return _json_error(err, _status_for(err))


async def dc_search(request: web.Request) -> web.Response:
    """(reference routes.py:253-273) tag search over the node's store."""
    ctx = _ctx(request)
    try:
        body = json.loads(await request.text())
        query = body.get("query") or []
        found = [o for store in ctx.all_stores() for o in store.search(query)]
        return web.json_response(
            {"content": bool(found), "count": len(found)}
        )
    except Exception as err:  # noqa: BLE001 — HTTP boundary
        return _json_error(err, _status_for(err))


# ── users HTTP CRUD (reference routes/{user,role,group}_related.py) ──────────


def _ws_twin(event_type: str):
    async def handler(request: web.Request) -> web.Response:
        ctx = _ctx(request)
        try:
            data = json.loads(await request.text()) if request.can_read_body else {}
        except json.JSONDecodeError as err:
            return _json_error(err, 400)
        token = request.headers.get("token")
        if token and "token" not in data:
            data["token"] = token
        data.update(
            {k: v for k, v in request.match_info.items() if k not in data}
        )
        response = _USER_HANDLERS[event_type](
            ctx, {MSG_FIELD.DATA: data}, Connection(ctx)
        )
        status = 200 if "error" not in response else 400
        return web.json_response(response, status=status)

    return handler


# ── registration ─────────────────────────────────────────────────────────────


def register(app: web.Application) -> None:
    r = app.router
    # model-centric (reference blueprint /model-centric)
    r.add_post("/model-centric/cycle-request", mc_cycle_request)
    r.add_route("*", "/model-centric/speed-test", mc_speed_test)
    r.add_post("/model-centric/report", mc_report)
    r.add_post("/model-centric/authenticate", mc_authenticate)
    r.add_get("/model-centric/get-model", mc_get_model)
    r.add_get("/model-centric/get-plan", mc_get_plan)
    r.add_get("/model-centric/get-protocol", mc_get_protocol)
    r.add_get("/model-centric/req-join", mc_req_join)
    r.add_get("/model-centric/retrieve-model", mc_retrieve_model)
    r.add_get("/model-centric/cycle-metrics", mc_cycle_metrics)
    r.add_get("/model-centric/processes", mc_processes)
    # data-centric (reference blueprint /data-centric)
    r.add_get("/data-centric/models/", dc_models)
    r.add_get("/data-centric/detailed-models-list/", dc_detailed_models)
    r.add_get("/data-centric/identity/", dc_identity)
    r.add_get("/metrics", metrics)
    # telemetry (no reference analog — SURVEY §5.1: stdlib logging only)
    r.add_get("/telemetry/cycles", telemetry_cycles)
    r.add_get("/telemetry/cycles/{id}", telemetry_cycle_detail)
    r.add_get("/telemetry/events", telemetry_events)
    r.add_get("/telemetry/serving", telemetry_serving)
    r.add_get("/telemetry/programs", telemetry_programs)
    r.add_get("/telemetry/slo", telemetry_slo)
    r.add_post("/telemetry/dump", telemetry_dump)
    r.add_get("/healthz", healthz)
    r.add_post("/data-centric/run-generation", dc_run_generation)
    r.add_get("/data-centric/status/", dc_status)
    r.add_get("/data-centric/workers/", dc_workers)
    r.add_post("/data-centric/serve-model/", dc_serve_model)
    r.add_get("/data-centric/serve-model/", dc_download_model)
    r.add_get("/data-centric/dataset-tags", dc_dataset_tags)
    r.add_post("/data-centric/search-encrypted-models", dc_search_encrypted_models)
    r.add_post("/data-centric/search", dc_search)
    # users
    from pygrid_tpu_torch.utils.codes import GROUP_EVENTS, ROLE_EVENTS, USER_EVENTS

    r.add_post("/users/signup", _ws_twin(USER_EVENTS.SIGNUP_USER))
    r.add_post("/users/login", _ws_twin(USER_EVENTS.LOGIN_USER))
    r.add_get("/users/", _ws_twin(USER_EVENTS.GET_ALL_USERS))
    r.add_get("/users/{id}", _ws_twin(USER_EVENTS.GET_SPECIFIC_USER))
    r.add_post("/users/search", _ws_twin(USER_EVENTS.SEARCH_USERS))
    r.add_put("/users/{id}/email", _ws_twin(USER_EVENTS.PUT_EMAIL))
    r.add_put("/users/{id}/password", _ws_twin(USER_EVENTS.PUT_PASSWORD))
    r.add_put("/users/{id}/role", _ws_twin(USER_EVENTS.PUT_ROLE))
    r.add_put("/users/{id}/groups", _ws_twin(USER_EVENTS.PUT_GROUPS))
    r.add_delete("/users/{id}", _ws_twin(USER_EVENTS.DELETE_USER))
    r.add_post("/roles/", _ws_twin(ROLE_EVENTS.CREATE_ROLE))
    r.add_get("/roles/", _ws_twin(ROLE_EVENTS.GET_ALL_ROLES))
    r.add_get("/roles/{id}", _ws_twin(ROLE_EVENTS.GET_ROLE))
    r.add_put("/roles/{id}", _ws_twin(ROLE_EVENTS.PUT_ROLE))
    r.add_delete("/roles/{id}", _ws_twin(ROLE_EVENTS.DELETE_ROLE))
    r.add_post("/groups/", _ws_twin(GROUP_EVENTS.CREATE_GROUP))
    r.add_get("/groups/", _ws_twin(GROUP_EVENTS.GET_ALL_GROUPS))
    r.add_get("/groups/{id}", _ws_twin(GROUP_EVENTS.GET_GROUP))
    r.add_put("/groups/{id}", _ws_twin(GROUP_EVENTS.PUT_GROUP))
    r.add_delete("/groups/{id}", _ws_twin(GROUP_EVENTS.DELETE_GROUP))
