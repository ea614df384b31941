"""Grid telemetry — the port's copy of :mod:`pygrid_tpu.telemetry`'s
spine: the process-wide event bus (:mod:`.bus`: ring-buffered events,
labelled counters, log-linear histograms), distributed-trace context with
its 24-byte wire header (:mod:`.trace`), and the per-FL-cycle round
timelines the cycle manager writes (:mod:`.timeline`), the per-program
compile/execute profiler and device-memory sampler the serving programs
report to (:mod:`.profiler`), and the flight recorder the serving engine
dumps to on failure (:mod:`.recorder`).

The reference's ``slo``, ``promtext`` and ``http_middleware`` (aiohttp)
come with the port's apps and are not here yet.
"""

from __future__ import annotations

from pygrid_tpu_torch.telemetry import profiler, recorder, timeline, trace  # noqa: F401
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
