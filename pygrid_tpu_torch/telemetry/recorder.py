"""The flight recorder — a black box for postmortems.

Live ``/metrics`` scrapes answer "how is the grid doing *now*"; they
answer nothing once the interesting moment has passed. The recorder
keeps a process-wide bounded ring of notable moments (engine snapshots,
handler exceptions, bus annotations) and, on a trigger, writes one
self-contained **crash dump**: the ring, the telemetry bus's recent
structured events (spans included), every registered subsystem's live
stats, and the trigger's own snapshot — redacted, JSON-round-trippable,
and bounded on disk.

Triggers (docs/OBSERVABILITY.md §7):

- an unhandled WS/HTTP handler exception (``node/events.py`` dispatch
  boundary),
- a serving-engine ``_fail_all`` (every queued/live request failed),
- an operator's ``POST /telemetry/dump``.

Dumps land in ``PYGRID_FLIGHT_DIR`` (default: a ``pygrid-flight``
directory under the system temp dir), pruned to the newest
:data:`MAX_DUMPS` files, rate-limited per reason so an exception storm
produces one dump, not thousands. Every write increments
``flightrecorder_dumps_total{reason=…}``.

Redaction is structural: any mapping key that looks credential-like
(token/password/secret/…, see :data:`_REDACT_KEYS`) has its value
replaced before serialization — a dump must be shareable with an
operator channel without leaking a worker's request key or a session
token.

The port's copy of :mod:`pygrid_tpu.telemetry.recorder`, with the port's
imports; the dump's schema is the reference's.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
import weakref
from collections import deque
from typing import Any

from pygrid_tpu_torch.telemetry import bus

#: ring entries kept in memory (oldest evicted first)
RING_SIZE = 512

#: newest dump files kept on disk; older ones are pruned at write time
MAX_DUMPS = 20

#: bus ring events embedded in a dump
DUMP_EVENT_LIMIT = 256

#: flight-dump payload schema version (docs/OBSERVABILITY.md §7). The
#: dump's top-level shape — reason/ts/error/snapshot/ring/events/stats/
#: counters — is a STABLE machine-readable contract: replay tooling
#: (the JAX package's storm/replay.py) and external consumers key on it. Bump
#: only when an existing key changes shape or meaning; ADDING keys is
#: compatible and does not bump it.
SCHEMA_VERSION = 1

#: default seconds between dumps *per reason* (env-overridable)
DEFAULT_MIN_INTERVAL_S = 30.0

#: lowercase substrings that mark a mapping key as credential-bearing
_REDACT_KEYS = (
    "token", "password", "secret", "request_key", "authorization",
    "auth", "jwt", "api_key", "private_key",
)

_REDACTED = "[redacted]"

#: strings/bytes longer than this are truncated in dumps (a dump is a
#: postmortem index, not a payload archive)
_MAX_STR = 2048


def enabled() -> bool:
    """The recorder off-switch: ``PYGRID_FLIGHT=off|0`` turns ring
    appends and automatic dumps into no-ops (the operator's explicit
    ``dump(force=True)`` still works — asking for a dump IS consent)."""
    return os.environ.get("PYGRID_FLIGHT", "").lower() not in ("off", "0")


def flight_dir() -> str:
    """The crash-dump directory: ``PYGRID_FLIGHT_DIR`` or a stable
    tempdir fallback, created on demand."""
    path = os.environ.get("PYGRID_FLIGHT_DIR") or os.path.join(
        tempfile.gettempdir(), "pygrid-flight"
    )
    os.makedirs(path, exist_ok=True)
    return path


def redact(value: Any) -> Any:
    """Recursively copy ``value`` with credential-keyed fields replaced
    and oversized strings truncated; non-JSON leaves become ``repr``."""
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            key = str(k)
            if any(m in key.lower() for m in _REDACT_KEYS):
                out[key] = _REDACTED
            else:
                out[key] = redact(v)
        return out
    if isinstance(value, (list, tuple)):
        return [redact(v) for v in value]
    if isinstance(value, (bytes, bytearray, memoryview)):
        return f"<{len(value)} bytes>"
    if isinstance(value, str):
        return value if len(value) <= _MAX_STR else value[:_MAX_STR] + "…"
    if isinstance(value, (int, float, bool)) or value is None:
        return value
    return repr(value)


class FlightRecorder:
    def __init__(self, ring_size: int = RING_SIZE) -> None:
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=ring_size)
        self._last_dump: dict[str, float] = {}
        self._seq = 0  # uniquifies dump filenames within one millisecond
        #: name -> weakref to an object with a ``stats()`` method; the
        #: weakref keeps the recorder from pinning a closed app's
        #: serving manager (tests build hundreds of contexts)
        self._providers: dict[str, weakref.ref] = {}

    # ── producers ───────────────────────────────────────────────────────

    def note(self, kind: str, /, **fields: Any) -> None:
        """Append one moment to the ring — cheap enough for per-request
        paths (one lock, one dict; a no-op when disabled)."""
        if not enabled():
            return
        entry = {**fields, "kind": kind, "ts": time.time()}
        with self._lock:
            self._ring.append(entry)

    def register_stats_provider(self, name: str, obj: Any) -> None:
        """Snapshot ``obj.stats()`` into every future dump (held by
        weakref; dead providers are pruned at dump time)."""
        with self._lock:
            self._providers[name] = weakref.ref(obj)

    # ── consumers ───────────────────────────────────────────────────────

    def ring(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def _min_interval(self) -> float:
        return bus.env_float(
            "PYGRID_FLIGHT_MIN_INTERVAL_S", DEFAULT_MIN_INTERVAL_S
        )

    def _provider_stats(self) -> dict:
        with self._lock:
            providers = dict(self._providers)
        out = {}
        dead = []
        for name, ref in providers.items():
            obj = ref()
            if obj is None:
                dead.append(name)
                continue
            try:
                out[name] = obj.stats()
            except Exception as err:  # noqa: BLE001 — best-effort capture
                out[name] = {"error": str(err)}
        if dead:
            with self._lock:
                for name in dead:
                    if self._providers.get(name) is not None and (
                        self._providers[name]() is None
                    ):
                        del self._providers[name]
        return out

    def should_dump(self, reason: str) -> bool:
        """Cheap peek (no state change): would a ``dump(reason)`` write
        right now? The exception-storm path checks this BEFORE building
        snapshots or spawning a writer thread — the whole point of the
        rate limit is that the storm path costs one timestamp compare."""
        if not enabled():
            return False
        with self._lock:
            last = self._last_dump.get(reason)
        return last is None or (
            time.monotonic() - last >= self._min_interval()
        )

    def dump(
        self,
        reason: str,
        snapshot: Any = None,
        error: BaseException | str | None = None,
        force: bool = False,
        snapshot_redacted: bool = False,
    ) -> str | None:
        """Write one crash dump; returns its path, or None when the
        per-reason rate limit (or the off-switch) suppressed the write
        (``force=True`` — the operator's POST — always writes).
        ``snapshot_redacted`` marks a snapshot :func:`redact` already
        processed (the ``dump_soon`` path) so it is not walked twice."""
        if not force and not enabled():
            return None
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if not force and last is not None and (
                now - last < self._min_interval()
            ):
                return None
            # RESERVE the slot now (check-then-act would let every
            # trigger arriving during this write's few ms pass the
            # limiter and write its own dump); rolled back on a failed
            # write so a full disk doesn't suppress the next attempt
            self._last_dump[reason] = now
        payload = {
            "schema_version": SCHEMA_VERSION,
            "reason": reason,
            "ts": time.time(),
            "error": str(error) if error is not None else None,
            "snapshot": (
                snapshot if snapshot_redacted else redact(snapshot)
            ),
            "ring": redact(self.ring()),
            "events": redact(bus.events(limit=DUMP_EVENT_LIMIT)),
            "stats": redact(self._provider_stats()),
            "counters": {
                _counter_label(name, labels): value
                for (name, labels), value in sorted(bus.counters().items())
            },
        }
        directory = flight_dir()
        with self._lock:
            self._seq += 1
            seq = self._seq
        # millis alone can collide under rapid dumps — the sequence
        # number keeps names unique (and lexically chronological: the
        # prune relies on sort order)
        name = (
            f"flight-{int(time.time() * 1000):013d}-{seq:06d}-"
            f"{_slug(reason)}.json"
        )
        path = os.path.join(directory, name)
        try:
            # write-then-rename: a dump must appear ATOMICALLY — dump
            # consumers (and the tests) poll the directory and read as
            # soon as the name shows up, so an in-progress write must
            # not be observable as an empty/truncated JSON file. The
            # temp name is opaque (no reason slug, hidden) so no
            # directory poll can match it mid-write.
            tmp_path = os.path.join(directory, f".flight-{seq:06d}.tmp")
            with open(tmp_path, "w", encoding="utf-8") as fh:
                # default=repr: one unserializable leaf must not lose
                # the dump
                json.dump(payload, fh, indent=1, default=repr)
            os.replace(tmp_path, path)
        except BaseException:
            try:
                # a failed write must not strand its temp file in the
                # operator's dump directory (crash-looping full disks)
                os.unlink(tmp_path)
            except OSError:
                pass
            with self._lock:
                # roll back the reservation: nothing was captured, so
                # the next attempt must not be rate-limited away
                if self._last_dump.get(reason) == now:
                    if last is None:
                        self._last_dump.pop(reason, None)
                    else:
                        self._last_dump[reason] = last
            raise
        _prune(directory)
        bus.incr("flightrecorder_dumps_total", reason=reason)
        bus.record("flightrecorder.dump", reason=reason, path=path)
        return path

    def dump_soon(
        self,
        reason: str,
        snapshot: Any = None,
        error: BaseException | str | None = None,
    ) -> None:
        """Fire-and-forget dump on a short-lived thread — the handler
        dispatch path must not pay file I/O inline. The rate-limit check
        runs inside ``dump``; an exception storm spawns at most one
        writer per interval's worth of no-op threads."""
        if not self.should_dump(reason):
            return
        snapshot = redact(snapshot)  # capture caller state NOW, not later

        def _write() -> None:
            try:
                self.dump(reason, snapshot, error, snapshot_redacted=True)
            except Exception:  # noqa: BLE001 — capture is best-effort
                logging.getLogger(__name__).exception(
                    "flight-recorder capture failed"
                )

        threading.Thread(
            target=_write, name="pygrid-flight-dump", daemon=True
        ).start()

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._last_dump.clear()
            self._providers.clear()


#: default seconds between periodic engine snapshots (env-overridable)
DEFAULT_SNAPSHOT_INTERVAL_S = 10.0


class PeriodicSnapshotter:
    """Low-cadence engine snapshots onto the flight-recorder ring
    (docs/OBSERVABILITY.md §7): every ~10 s *under load*, one
    ``engine.snapshot`` note carrying every registered stats provider's
    live numbers — so a crash dump shows the trajectory BEFORE the
    crash (queue depths climbing, a fold stalling), not just the final
    frame. "Under load" is a counter-delta gate: an idle process writes
    nothing, keeping the ring for real moments and the cost at zero.

    Refcounted like the profiler's memory sampler: several apps in one
    process (the test grid) share the thread; it stops with the last
    ``stop()``."""

    def __init__(
        self, recorder: "FlightRecorder", interval_s: float | None = None
    ) -> None:
        self._recorder = recorder
        self._interval_override = interval_s
        self._stop_event = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._starts = 0
        self._last_counters: dict | None = None
        self.snapshots = 0  # taken (post-gate), for tests/stats

    def _interval(self) -> float:
        if self._interval_override is not None:
            return self._interval_override
        return max(
            0.05,
            bus.env_float(
                "PYGRID_FLIGHT_SNAPSHOT_S", DEFAULT_SNAPSHOT_INTERVAL_S
            ),
        )

    def start(self) -> None:
        with self._lock:
            self._starts += 1
            if self._thread is not None:
                return
            self._stop_event.clear()
            self._thread = threading.Thread(
                target=self._run, name="pygrid-flight-snapshot", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._starts = max(0, self._starts - 1)
            if self._starts > 0 or self._thread is None:
                return
            thread = self._thread
            self._thread = None
        self._stop_event.set()
        thread.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop_event.wait(self._interval()):
            try:
                self.snapshot_once()
            except Exception:  # noqa: BLE001 — cadence must survive
                logging.getLogger(__name__).exception(
                    "periodic engine snapshot failed"
                )

    def snapshot_once(self, force: bool = False) -> bool:
        """One gated snapshot; returns whether a note was written.
        ``force`` skips the activity gate (tests, operator paths)."""
        if not enabled():
            return False
        counters = dict(bus.counters())
        if not force and counters == self._last_counters:
            return False  # idle since the last tick — nothing to record
        self._recorder.note(
            "engine.snapshot",
            stats=redact(self._recorder._provider_stats()),
        )
        self.snapshots += 1
        bus.incr("flightrecorder_snapshots_total")
        # the gate's baseline is the POST-snapshot counter state — the
        # snapshot's own counter must not read as "activity" next tick
        self._last_counters = dict(bus.counters())
        return True


def _slug(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "-" for c in reason)[:48]


def _counter_label(name: str, labels: tuple) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


def _prune(directory: str) -> None:
    """Keep the newest :data:`MAX_DUMPS` files PER REASON: a flood of
    one reason (an operator scripting ``POST /telemetry/dump``, an
    exception storm) must not evict another reason's crash evidence —
    reasons are code-bounded, so the total stays bounded too."""
    try:
        by_reason: dict[str, list[str]] = {}
        for f in sorted(os.listdir(directory)):
            if f.startswith("flight-") and f.endswith(".json"):
                # filename shape: flight-<millis>-<seq>-<reason>.json
                slug = f[len("flight-"):-len(".json")].split("-", 2)[-1]
                by_reason.setdefault(slug, []).append(f)
        for dumps in by_reason.values():
            for stale in dumps[:-MAX_DUMPS]:
                os.unlink(os.path.join(directory, stale))
    except OSError:  # pruning is best-effort; the dump already landed
        pass


#: the process-wide recorder — module functions are its bound methods
RECORDER = FlightRecorder()
#: its periodic-snapshot thread (started by app lifecycles, refcounted)
SNAPSHOTTER = PeriodicSnapshotter(RECORDER)

note = RECORDER.note
dump = RECORDER.dump
dump_soon = RECORDER.dump_soon
should_dump = RECORDER.should_dump
ring = RECORDER.ring
register_stats_provider = RECORDER.register_stats_provider
reset = RECORDER.reset
start_snapshots = SNAPSHOTTER.start
stop_snapshots = SNAPSHOTTER.stop
