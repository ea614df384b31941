"""Grid telemetry — the port's copy of :mod:`pygrid_tpu.telemetry`'s
spine: the process-wide event bus (:mod:`.bus`: ring-buffered events,
labelled counters, log-linear histograms), distributed-trace context with
its 24-byte wire header (:mod:`.trace`), and the per-FL-cycle round
timelines the cycle manager writes (:mod:`.timeline`), the per-program
compile/execute profiler and device-memory sampler the serving programs
report to (:mod:`.profiler`), and the flight recorder the serving engine
dumps to on failure (:mod:`.recorder`), declarative burn-rate SLOs over
the bus histograms (:mod:`.slo`), the strict Prometheus text parser the
scrape-validity checks use (:mod:`.promtext`), and
:func:`http_middleware`, the node's request-latency and status-code
middleware over the port's own :mod:`pygrid_tpu_torch.web`.
"""

from __future__ import annotations

from pygrid_tpu_torch.telemetry import (  # noqa: F401
    profiler,
    promtext,
    recorder,
    slo,
    timeline,
    trace,
)
from pygrid_tpu_torch.telemetry.bus import (  # noqa: F401
    BUS,
    Histogram,
    counters,
    events,
    histograms,
    incr,
    observe,
    record,
    reset,
)
from pygrid_tpu_torch.telemetry.trace import (  # noqa: F401
    TRACE_HEADER,
    TraceContext,
    current,
    span,
)


def export(exp) -> None:
    """Write every bus counter and histogram family into a
    :class:`pygrid_tpu_torch.utils.metrics.Exposition` — the one exporter
    the node and network ``/metrics`` routes call, so the exposed families
    cannot drift between the two apps."""
    from pygrid_tpu_torch.serde import tensor_copy_count
    from pygrid_tpu_torch.telemetry.bus import family_help

    for (name, labels), value in sorted(counters().items()):
        exp.counter(name, value, family_help(name), dict(labels))
    for (name, labels), snap in sorted(histograms().items()):
        exp.histogram(name, snap, family_help(name), dict(labels))
    exp.counter(
        "serde_tensor_copies_total",
        tensor_copy_count(),
        "tensor-buffer byte copies made by wire deserialization",
    )


def http_middleware():
    """The apps' middleware over :mod:`pygrid_tpu_torch.web`: adopts the
    ``X-PyGrid-Trace`` header (or synthesizes a root trace for legacy
    clients), and feeds the per-route request-latency histogram and
    status-code counter. ``route`` is the matched resource's canonical
    path, ``"unmatched"`` when the router found none (404 and 405, which
    it raises). WebSocket upgrades are counted but not timed — a
    connection's lifetime is not a request latency."""
    import time

    from pygrid_tpu_torch import web

    @web.middleware
    async def middleware(request, handler):
        incoming = trace.parse_header(
            request.headers.get(TRACE_HEADER, "")
        )
        route = "unmatched"
        resource = request.match_info.route.resource
        if resource is not None:
            route = resource.canonical
        t0 = time.monotonic()
        status = 500
        websocket = False
        with trace.serve(incoming):
            try:
                try:
                    response = await handler(request)
                except web.HTTPException as err:
                    # the router signals 404/405 (and a handler may signal
                    # 413) by raising — that's the status the client sees,
                    # not a 500
                    status = err.status
                    raise
                status = response.status
                websocket = isinstance(response, web.WebSocketResponse)
                return response
            finally:
                incr(
                    "http_requests_total",
                    1,
                    route=route,
                    code=str(status),
                )
                if not websocket:
                    observe(
                        "http_request_seconds",
                        time.monotonic() - t0,
                        route=route,
                    )

    return middleware
