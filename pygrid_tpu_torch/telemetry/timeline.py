"""Per-FL-cycle round timelines.

Answers "where did this cycle's 8 seconds go?" in one place: per-phase
durations, per-worker report latency, wire bytes per codec, straggler
counts, and the trace ids that stitch the cycle to client spans. The
node's ``CycleManager`` feeds these hooks at assign/report/aggregate
time; ``GET /telemetry/cycles/<id>`` serves the snapshot (merged with
the durable worker rows from SQL).

In-memory and bounded (the durable record is the worker-cycle table):
the registry keeps the most recent :data:`MAX_CYCLES` cycles and evicts
oldest-first. All hooks are no-fail — a telemetry bug must never break
a cycle — and cheap enough for the per-report path.

The port's copy of :mod:`pygrid_tpu.telemetry.timeline`, with the port's imports.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any

#: cycles kept in memory (oldest evicted first)
MAX_CYCLES = 256

_lock = threading.Lock()
_cycles: "OrderedDict[int, dict]" = OrderedDict()


def _fresh_entry(cycle_id: int) -> dict:
    return {
        "cycle_id": cycle_id,
        "fl_process_id": None,
        "sequence": None,
        "created_ts": time.time(),
        "completed_ts": None,
        "phases": {},          # phase name -> cumulative seconds
        "workers": {},         # worker_id -> report record
        "bytes": {},           # "direction/codec" -> bytes
        "traces": [],          # trace ids seen for this cycle
        "assigned": 0,
        "reported": 0,
        "stragglers": None,
        "outcome": None,
    }


def _get_or_create(cycle_id: int) -> dict:
    """Caller holds ``_lock``."""
    entry = _cycles.get(cycle_id)
    if entry is None:
        entry = _cycles[cycle_id] = _fresh_entry(cycle_id)
        while len(_cycles) > MAX_CYCLES:
            _cycles.popitem(last=False)
    return entry


def cycle_started(
    cycle_id: int,
    fl_process_id: int | None = None,
    sequence: int | None = None,
) -> None:
    with _lock:
        # a NEW cycle under an already-seen id (fresh DB after a restart,
        # or the in-process test grid re-numbering from 1) replaces the
        # stale record outright — and re-enters the eviction order at the
        # back, so `recent()` reflects creation recency, not first-ever
        # sighting of the id
        _cycles.pop(cycle_id, None)
        entry = _get_or_create(cycle_id)
        entry["fl_process_id"] = fl_process_id
        entry["sequence"] = sequence


def worker_assigned(
    cycle_id: int, worker_id: str, trace_id: str | None = None
) -> None:
    with _lock:
        entry = _get_or_create(cycle_id)
        entry["assigned"] += 1
        entry["workers"].setdefault(
            worker_id, {"assigned_ts": time.time()}
        )
        _note_trace(entry, trace_id)


def worker_report(
    cycle_id: int,
    worker_id: str,
    latency_s: float | None = None,
    n_bytes: int = 0,
    codec: str | None = None,
    trace_id: str | None = None,
) -> None:
    with _lock:
        entry = _get_or_create(cycle_id)
        entry["reported"] += 1
        rec = entry["workers"].setdefault(worker_id, {})
        rec.update(
            {
                "report_latency_s": latency_s,
                "report_bytes": n_bytes,
                "codec": codec,
                "trace_id": trace_id,
                "reported_ts": time.time(),
            }
        )
        _note_trace(entry, trace_id)
        _add_bytes(entry, "upload", codec, n_bytes)


def add_bytes(
    cycle_id: int, direction: str, codec: str | None, n_bytes: int
) -> None:
    with _lock:
        _add_bytes(_get_or_create(cycle_id), direction, codec, n_bytes)


def phase(cycle_id: int, name: str, seconds: float) -> None:
    with _lock:
        phases = _get_or_create(cycle_id)["phases"]
        phases[name] = phases.get(name, 0.0) + float(seconds)


def cycle_closed(
    cycle_id: int,
    assigned: int | None = None,
    reported: int | None = None,
    outcome: str = "aggregated",
) -> None:
    with _lock:
        entry = _get_or_create(cycle_id)
        entry["completed_ts"] = time.time()
        entry["outcome"] = outcome
        if assigned is not None:
            entry["assigned"] = assigned
        if reported is not None:
            entry["reported"] = reported
        entry["stragglers"] = max(
            0, entry["assigned"] - entry["reported"]
        )


def snapshot(cycle_id: int) -> dict | None:
    """Deep-enough copy for a JSON response; None when unknown (evicted
    or never observed — the route then falls back to SQL alone)."""
    with _lock:
        entry = _cycles.get(cycle_id)
        if entry is None:
            return None
        out = dict(entry)
        out["phases"] = dict(entry["phases"])
        out["workers"] = {k: dict(v) for k, v in entry["workers"].items()}
        out["bytes"] = dict(entry["bytes"])
        out["traces"] = list(entry["traces"])
        return out


def recent(limit: int = 20) -> list[dict]:
    """Newest-first summaries for the listing route / dashboard."""
    with _lock:
        ids = list(_cycles.keys())[-limit:][::-1]
    out = []
    for cid in ids:
        snap = snapshot(cid)
        if snap is None:
            continue
        out.append(
            {
                k: snap[k]
                for k in (
                    "cycle_id", "fl_process_id", "sequence", "created_ts",
                    "completed_ts", "assigned", "reported", "stragglers",
                    "outcome", "phases",
                )
            }
        )
    return out


def reset() -> None:
    with _lock:
        _cycles.clear()


def _note_trace(entry: dict, trace_id: str | None) -> None:
    if trace_id and trace_id not in entry["traces"]:
        entry["traces"].append(trace_id)


def _add_bytes(
    entry: dict, direction: str, codec: str | None, n_bytes: int
) -> None:
    if n_bytes:
        key = f"{direction}/{codec or 'raw'}"
        entry["bytes"][key] = entry["bytes"].get(key, 0) + int(n_bytes)


def merge_db_workers(snap: dict, rows: list[Any]) -> dict:
    """Fold the durable worker-cycle rows into a snapshot: the in-memory
    record has wire detail (bytes/codec/trace) for reports this process
    saw; the SQL rows are authoritative for who was assigned and when —
    a restarted node still serves a useful timeline."""
    workers = snap.setdefault("workers", {})
    for row in rows:
        rec = workers.setdefault(row.worker_id, {})
        if getattr(row, "started_at", None) is not None:
            rec.setdefault("assigned_at", row.started_at.isoformat())
        completed_at = getattr(row, "completed_at", None)
        if completed_at is not None:
            rec.setdefault("reported_at", completed_at.isoformat())
            started_at = getattr(row, "started_at", None)
            if started_at is not None:
                rec.setdefault(
                    "report_latency_s",
                    (completed_at - started_at).total_seconds(),
                )
    return snap
