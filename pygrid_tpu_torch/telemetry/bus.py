"""The process-wide telemetry event bus.

Always on, by design: there is no enable flag to forget in production,
so every code path pays the bus's cost on every call — which is why the
implementation is deliberately boring. One small lock held for a few
dict/list operations per call (no I/O, no allocation beyond the event
dict itself), a bounded ring for structured events, plain integer
counters, and fixed-bucket histograms. The JAX package's
``bench.bench_telemetry_overhead`` holds its instrumented wire round
within 2% of the bare wire path.

Histograms use **log-linear buckets**: a 1 / 2.5 / 5 ladder per decade
(the classic SRE latency ladder), spanning 1µs to 500s by default. Log
spacing keeps the bucket count small across nine decades; the linear
subdivision inside each decade keeps quantile estimates honest where
latencies actually cluster.

The port's copy of :mod:`pygrid_tpu.telemetry.bus`, with the port's imports.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Any, Iterable

#: structured events kept in memory (oldest evicted first)
RING_SIZE = 4096

#: distinct label sets allowed per counter/histogram family before new
#: sets fold into ``{other="true"}`` — a misbehaving client cycling
#: label values (model ids, event names) must not grow /metrics without
#: bound; every fold increments ``telemetry_labels_dropped_total``
MAX_LABELSETS = 64

#: per-family cap overrides: families whose label values legitimately
#: scale with GRID SIZE (one series per node) get a higher ceiling —
#: folding node #65's heartbeat into ``other`` would silently disable
#: the per-node SLO grouping and the monitor's degraded detection
FAMILY_MAX_LABELSETS: dict[str, int] = {
    "heartbeat_rtt_seconds": 1024,
    "monitor_polls_total": 1024,
}

#: the fold target for over-cardinality label sets
_OTHER_KEY = (("other", "true"),)


def log_linear_bounds(
    lo_exp: int = -6,
    hi_exp: int = 2,
    steps: Iterable[float] = (1.0, 2.5, 5.0),
) -> list[float]:
    """Bucket upper bounds: ``step × 10^e`` for each decade — log-linear."""
    return [m * (10.0 ** e) for e in range(lo_exp, hi_exp + 1) for m in steps]


#: default bounds for seconds-valued histograms (1µs … 500s, 27 buckets)
DEFAULT_SECONDS_BOUNDS = log_linear_bounds()


class Histogram:
    """Fixed-bound histogram with a Prometheus-shaped snapshot."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Iterable[float] | None = None) -> None:
        self.bounds = sorted(bounds) if bounds else list(DEFAULT_SECONDS_BOUNDS)
        self.counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        # le is an *inclusive* upper bound (Prometheus semantics):
        # bisect_left sends v == bound into that bound's bucket
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def snapshot(self) -> dict:
        """``{"buckets": [(le, cumulative_count), ...], "sum", "count"}``
        with cumulative counts and a trailing ``+Inf`` bucket — exactly
        what ``Exposition.histogram`` renders."""
        buckets = []
        running = 0
        for le, c in zip(self.bounds, self.counts):
            running += c
            buckets.append((le, running))
        buckets.append((float("inf"), running + self.counts[-1]))
        return {"buckets": buckets, "sum": self.sum, "count": self.count}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


#: HELP text per metric family — registered at first use, read by the
#: exporter so /metrics carries real descriptions, not just names
_FAMILY_HELP: dict[str, str] = {
    "events_total": "structured telemetry events recorded, by event name",
    "http_requests_total": "HTTP requests served, by route and status",
    "http_request_seconds": "HTTP request latency by route",
    "node_event_seconds": "WS/HTTP event handler latency by event type",
    "ws_frame_decode_seconds": "wire-v2 binary frame decode time",
    "wire_bytes_total": "bytes over the websocket wire, by direction/codec",
    "report_bytes_total": "FL diff upload bytes, by wire codec",
    "model_download_bytes_total": "FL checkpoint download bytes, by codec",
    "report_latency_seconds": "worker assign-to-report latency",
    "cycle_phase_seconds": "FL cycle phase durations, by phase",
    "cycles_completed_total": "FL cycles closed, by outcome",
    "heartbeat_rtt_seconds": "network→node heartbeat round trip, by transport",
    "monitor_polls_total": "monitor sweeps per node, by outcome",
    # continuous-batching generation engine (serving/)
    "serving_requests_total": "generation requests, by model and outcome",
    "serving_tokens_total": "generated tokens served, by model",
    "serving_compiles_total": "serving program compiles, by kind",
    "serving_ttft_seconds": "generation time-to-first-token (enqueue→token)",
    "serving_token_seconds": "per-token decode latency inside the batch",
    "serving_prefill_seconds": "per-request slot prefill (admission) time",
    "serving_queue_wait_seconds": "generation queue wait before a slot",
    "serving_batch_occupancy": "live slots per decode step",
    # paged KV cache (docs/SERVING.md): block tables + prefix sharing
    "serving_prefix_lookups_total": (
        "prompt-prefix cache lookups at admission, by model and outcome"
    ),
    "serving_prefix_tokens_saved_total": (
        "prompt tokens NOT re-prefilled thanks to prefix hits, by model"
    ),
    "serving_blocks_per_request": "KV pool blocks held per admitted request",
    # fused multi-step + speculative decode (docs/SERVING.md)
    "serving_fused_scans_total": (
        "fused multi-step decode scans dispatched, by model"
    ),
    "serving_fused_steps_total": (
        "device decode steps executed inside fused scans, by model"
    ),
    "serving_fused_wasted_steps_total": (
        "frozen row-steps burned by rows finishing mid-scan, by model"
    ),
    "serving_spec_verifies_total": (
        "speculative draft-propose + verify cycles, by model"
    ),
    "serving_spec_proposed_total": (
        "draft tokens proposed for verification, by model"
    ),
    "serving_spec_accepted_total": (
        "draft tokens accepted by the target model, by model — "
        "accepted/proposed is the per-model acceptance rate"
    ),
    "slo_webhook_posts_total": (
        "SLO breach-webhook deliveries, by objective and outcome"
    ),
    "slo_breach_detect_seconds": (
        "injected-fault to breach-detection latency, by objective "
        "(only observed when a fault is marked via slo.mark_fault)"
    ),
    # observability engine (telemetry/{profiler,recorder,slo}.py)
    "profiler_compile_seconds": "jitted-program calls that compiled, by kind",
    "profiler_execute_seconds": "jitted-program steady-state calls, by kind",
    "flightrecorder_dumps_total": "flight-recorder crash dumps, by reason",
    "flightrecorder_snapshots_total": (
        "periodic engine snapshots written to the flight-recorder ring"
    ),
    # hierarchical aggregation tree (docs/AGGREGATION.md)
    "aggregation_partials_total": (
        "partial subtree reports, by outcome (node accepts + edge flushes)"
    ),
    "aggregation_leaf_reports_total": (
        "worker reports standing behind accepted partials"
    ),
    "aggregation_partial_fold_seconds": (
        "node-side partial ingest: validate, zero-copy merge, durability"
    ),
    "aggregation_subaggs_total": (
        "sub-aggregator placement registry churn, by outcome"
    ),
    "subagg_reports_total": (
        "frames folded at a sub-aggregator, by kind (leaf/partial)"
    ),
    "subagg_flush_seconds": "one sub-aggregator upstream flush round trip",
    "telemetry_labels_dropped_total": (
        "label sets folded into {other} by the cardinality guard, by family"
    ),
}


def family_help(name: str) -> str:
    return _FAMILY_HELP.get(name, f"pygrid telemetry metric {name}")


def env_float(name: str, default: float) -> float:
    """Env knob parse shared by the observability modules: a typo'd
    value falls back to the default instead of raising — a knob must
    never brick an import or an app startup."""
    import os

    try:
        return float(os.environ[name])
    except (KeyError, TypeError, ValueError):
        return default


def env_int(name: str, default: int) -> int:
    """Integer twin of :func:`env_float`, same never-brick contract."""
    import os

    try:
        return int(os.environ[name])
    except (KeyError, TypeError, ValueError):
        return default


class TelemetryBus:
    def __init__(
        self,
        ring_size: int = RING_SIZE,
        max_labelsets: int = MAX_LABELSETS,
    ) -> None:
        self._lock = threading.Lock()
        self._events: deque[dict] = deque(maxlen=ring_size)
        self._counters: dict[tuple[str, tuple], float] = {}
        self._histograms: dict[tuple[str, tuple], Histogram] = {}
        self._max_labelsets = max_labelsets
        #: family name -> distinct label sets admitted so far
        self._labelsets: dict[str, int] = {}

    def _admit(
        self, name: str, labels_key: tuple, existing: dict
    ) -> tuple[str, tuple]:
        """Under the lock: the storage key for one sample. A family at
        its cardinality cap folds NEW label sets into ``{other="true"}``
        (and counts the fold) instead of growing /metrics forever;
        existing series and unlabeled samples always pass."""
        key = (name, labels_key)
        if not labels_key or key in existing:
            return key
        admitted = self._labelsets.get(name, 0)
        cap = FAMILY_MAX_LABELSETS.get(name, self._max_labelsets)
        if admitted >= cap:
            dropped = (
                "telemetry_labels_dropped_total", (("family", name),)
            )
            self._counters[dropped] = self._counters.get(dropped, 0) + 1
            return (name, _OTHER_KEY)
        self._labelsets[name] = admitted + 1
        return key

    # ── producers (the hot-path surface) ────────────────────────────────

    def record(self, event: str, /, **fields: Any) -> None:
        """Append a structured event to the ring and count its family.
        ``event`` is positional-only so fields named ``event`` cannot
        collide; the name key still wins in the stored entry."""
        entry = {**fields, "event": event, "ts": time.time()}
        with self._lock:
            self._events.append(entry)
            key = self._admit(
                "events_total", (("event", event),), self._counters
            )
            self._counters[key] = self._counters.get(key, 0) + 1

    def incr(self, name: str, value: float = 1, **labels: Any) -> None:
        with self._lock:
            key = self._admit(name, _label_key(labels), self._counters)
            self._counters[key] = self._counters.get(key, 0) + value

    def observe(
        self,
        name: str,
        value: float,
        bounds: Iterable[float] | None = None,
        **labels: Any,
    ) -> None:
        with self._lock:
            key = self._admit(name, _label_key(labels), self._histograms)
            hist = self._histograms.get(key)
            if hist is None:
                hist = self._histograms[key] = Histogram(bounds)
            hist.observe(value)

    # ── consumers (snapshots — never expose live internals) ─────────────

    def events(
        self, event: str | None = None, limit: int | None = None
    ) -> list[dict]:
        with self._lock:
            out = list(self._events)
        if event is not None:
            out = [e for e in out if e.get("event") == event]
        if limit is not None:
            out = out[-limit:]
        return out

    def counters(self) -> dict[tuple[str, tuple], float]:
        with self._lock:
            return dict(self._counters)

    def histograms(self) -> dict[tuple[str, tuple], dict]:
        with self._lock:
            return {k: h.snapshot() for k, h in self._histograms.items()}

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._counters.clear()
            self._histograms.clear()
            self._labelsets.clear()


#: the process-wide bus — module functions below are its bound methods,
#: so call sites stay one import + one call
BUS = TelemetryBus()

record = BUS.record
incr = BUS.incr
observe = BUS.observe
events = BUS.events
counters = BUS.counters
histograms = BUS.histograms
reset = BUS.reset
