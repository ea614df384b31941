"""Burn-rate SLOs over the telemetry bus — the machine-readable notion
of "healthy".

An :class:`Objective` declares what good looks like for one latency
family already on the bus (``serving_ttft_seconds``,
``node_event_seconds{event=model-centric/report}``, …): a threshold and
a target fraction of events under it. The :class:`SLOEngine` evaluates
objectives the Google-SRE way — **multi-window burn rates** — instead
of point-in-time averages: the bus histograms are cumulative, so the
engine snapshots (count, good-count) per objective on a cadence and
differences snapshots across windows (default 5 min and 1 h). Burn
rate = (bad fraction over the window) / (error budget); 1.0 means the
budget is being consumed exactly as fast as it accrues.

Status policy (rendered at ``GET /telemetry/slo``, the dashboard SLO
table, and the deep ``/healthz``):

- ``ok``      — every window burn ≤ 1 and compliance at target
- ``warn``    — a window burns > 1, or lifetime compliance is below
  target (budget being eaten / ticket-worthy, not on fire)
- ``breach``  — the short window burns ≥ :data:`PAGE_BURN` on at least
  :data:`MIN_EVENTS` observations while the long window confirms
  (> :data:`CONFIRM_BURN`) — page someone. Breach is windowed-burn
  ONLY: a cumulative-compliance rule would latch deep ``/healthz`` at
  503 for hours after an incident ends
- ``no_data`` — the family has no observations yet

Thresholds/targets are env-tunable (``PYGRID_SLO_*`` —
docs/OBSERVABILITY.md §8). Grouped objectives (``group_by="node"`` on
heartbeat RTT) additionally expose per-label burn, which is how the
network monitor marks a node **degraded** — alive, but eating its
latency budget — rather than only dead.

The port's copy of :mod:`pygrid_tpu.telemetry.slo`, with the port's imports.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable

from pygrid_tpu_torch.telemetry import bus

logger = logging.getLogger(__name__)

#: short-window burn that pages (the classic 14.4 = 30-day budget gone
#: in 2 days) and the long-window burn that confirms it is not a blip
PAGE_BURN = 14.4
CONFIRM_BURN = 6.0

#: minimum short-window observations before a burn verdict can breach —
#: one slow request in an otherwise-idle window must not page
MIN_EVENTS = 10

#: evaluation windows, seconds (short, long) — env-overridable
DEFAULT_WINDOWS = (300.0, 3600.0)

#: snapshots retained; at the default 15 s tick this covers > 2 h
MAX_SNAPSHOTS = 512

#: status transitions retained per engine (reaction-latency reads)
MAX_TRANSITIONS = 256


# ── fault clock ─────────────────────────────────────────────────────────
#
# Deliberately injected faults (the JAX package's storm harness, or an
# operator's chaos drill) mark their injection time here; when an
# objective then transitions INTO breach, the engine measures
# injection→detection as the ``slo_breach_detect_seconds`` histogram —
# the reaction latency dashboards and storm assertions read. Unmarked
# production incidents simply never feed the histogram.

_fault_lock = threading.Lock()
_fault_marks: dict[str, float] = {}


def mark_fault(label: str = "fault", ts: float | None = None) -> float:
    """Record a deliberate fault's injection time (monotonic clock);
    returns the recorded timestamp. Re-marking a label overwrites it."""
    ts = ts if ts is not None else time.monotonic()
    with _fault_lock:
        _fault_marks[label] = ts
    return ts


def clear_fault(label: str | None = None) -> None:
    """Forget one fault mark (or all of them): the fault was cleared,
    so later breaches are not attributed to it."""
    with _fault_lock:
        if label is None:
            _fault_marks.clear()
        else:
            _fault_marks.pop(label, None)


def last_fault_ts() -> float | None:
    """The newest outstanding fault mark, or None when nothing is
    marked — breach transitions only measure detection latency against
    a fault that is actually standing."""
    with _fault_lock:
        return max(_fault_marks.values()) if _fault_marks else None


@dataclass(frozen=True)
class Objective:
    """One declarative SLO over a bus histogram family."""

    name: str
    family: str
    threshold_s: float
    target: float = 0.95
    #: label subset the family's series must match (None: every series)
    labels: dict | None = None
    #: label key to ALSO break burn out by (e.g. ``node``)
    group_by: str | None = None
    description: str = ""

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - self.target)


#: shared env-knob parse (telemetry.bus.env_float) under the local
#: name the objective factories below read naturally
_env_float = bus.env_float


def windows_from_env() -> tuple[float, ...]:
    raw = os.environ.get("PYGRID_SLO_WINDOWS", "")
    try:
        parsed = tuple(
            float(part) for part in raw.split(",") if part.strip()
        )
    except ValueError:
        parsed = ()
    return parsed or DEFAULT_WINDOWS


def node_objectives() -> list[Objective]:
    """The node's default objectives (docs/OBSERVABILITY.md §8)."""
    return [
        Objective(
            name="serving_ttft",
            family="serving_ttft_seconds",
            threshold_s=_env_float("PYGRID_SLO_TTFT_S", 1.0),
            target=_env_float("PYGRID_SLO_TTFT_TARGET", 0.95),
            description="generation time-to-first-token under threshold",
        ),
        Objective(
            name="report_handler",
            family="node_event_seconds",
            labels={"event": "model-centric/report"},
            threshold_s=_env_float("PYGRID_SLO_REPORT_S", 0.5),
            target=_env_float("PYGRID_SLO_REPORT_TARGET", 0.99),
            description="FL report handler latency under threshold",
        ),
        Objective(
            name="cycle_round",
            family="cycle_phase_seconds",
            labels={"phase": "aggregate"},
            threshold_s=_env_float("PYGRID_SLO_CYCLE_S", 30.0),
            target=_env_float("PYGRID_SLO_CYCLE_TARGET", 0.95),
            description="FL cycle aggregation duration under threshold",
        ),
    ]


def network_objectives() -> list[Objective]:
    """The network's default objectives: heartbeat RTT, grouped per
    node so the monitor can mark individual nodes degraded."""
    return [
        Objective(
            name="heartbeat_rtt",
            family="heartbeat_rtt_seconds",
            threshold_s=_env_float("PYGRID_SLO_HEARTBEAT_S", 2.0),
            target=_env_float("PYGRID_SLO_HEARTBEAT_TARGET", 0.9),
            group_by="node",
            description="node heartbeat round trip under threshold",
        ),
    ]


@dataclass
class _Snapshot:
    ts: float
    #: objective name -> group value ("" = the ungrouped aggregate)
    #: -> (count, good)
    totals: dict[str, dict[str, tuple[int, int]]] = field(
        default_factory=dict
    )


def _good_count(snap: dict, threshold_s: float) -> int:
    """Observations ≤ threshold from a cumulative bucket snapshot: the
    count at the smallest bound ≥ threshold (bucket-resolution
    optimistic, like PromQL's histogram math — documented)."""
    for le, cumulative in snap["buckets"]:
        if le >= threshold_s:
            return cumulative
    return snap["count"]


class BreachNotifier:
    """Push-side SLO alerting: ONE webhook POST per objective STATUS
    TRANSITION (``/telemetry/slo`` is pull-only; an operator who isn't
    scraping still learns the moment an objective breaches — and the
    moment it recovers).

    Configured by ``PYGRID_SLO_WEBHOOK_URL`` (unset: the notifier is a
    no-op — the default; nothing phones anywhere unasked). Transitions
    involving ``warn``/``breach`` on either side post; ``no_data``⇄``ok``
    churn (process start, idle families) is noise and does not. Each
    objective is rate-limited (``PYGRID_SLO_WEBHOOK_MIN_S``, default
    60 s) so a flapping objective cannot flood the receiver, and every
    transition INTO ``breach`` attaches the flight recorder's crash
    dump (ring + engine snapshots + counters — the state that explains
    the breach) inline in the payload. Delivery runs on a daemon
    thread: a slow or dead receiver never blocks ``evaluate()`` (which
    handlers call on scrape paths). Outcomes land on
    ``slo_webhook_posts_total{objective, outcome}``."""

    def __init__(
        self,
        url: str | None = None,
        min_interval_s: float | None = None,
    ) -> None:
        self.url = (
            url
            if url is not None
            else os.environ.get("PYGRID_SLO_WEBHOOK_URL") or None
        )
        self.min_interval_s = (
            min_interval_s
            if min_interval_s is not None
            else bus.env_float("PYGRID_SLO_WEBHOOK_MIN_S", 60.0)
        )
        self._lock = threading.Lock()
        self._last_status: dict[str, str] = {}
        self._last_post: dict[str, float] = {}

    @staticmethod
    def _worth_posting(prev: str, status: str) -> bool:
        return "breach" in (prev, status) or "warn" in (prev, status)

    def observe(self, rows: list[dict]) -> None:
        """Feed one ``evaluate()`` result; fires POSTs for transitions.
        Cheap when unconfigured (status tracking only).

        ``_last_status`` tracks the last status the receiver was TOLD
        about: a transition suppressed by the rate limit is retried on
        the next evaluate tick (it stays pending) rather than dropped —
        otherwise a breach→ok recovery landing inside the interval
        would leave the operator's view showing a standing breach that
        ended long ago. Flapping still converges: posts are bounded to
        one per interval per objective, and the final stable state
        always goes out once the interval clears."""
        for row in rows:
            name, status = row["name"], row["status"]
            now = time.monotonic()
            rate_limited = False
            post = False
            # ONE lock acquisition per row: a read-decide-update split
            # would let two racing evaluate() callers both see the old
            # status and double-post a single transition
            with self._lock:
                prev = self._last_status.get(name)
                if prev is None or status == prev:
                    self._last_status[name] = status
                elif not self.url or not self._worth_posting(
                    prev, status
                ):
                    self._last_status[name] = status
                else:
                    last = self._last_post.get(name)
                    if last is not None and (
                        now - last < self.min_interval_s
                    ):
                        # pending, not dropped: _last_status keeps the
                        # last POSTED value so the next tick retries
                        rate_limited = True
                    else:
                        self._last_post[name] = now
                        self._last_status[name] = status
                        post = True
            if rate_limited:
                bus.incr(
                    "slo_webhook_posts_total", objective=name,
                    outcome="rate_limited",
                )
            if not post:
                continue
            payload = {
                "objective": name,
                "from": prev,
                "to": status,
                "ts": time.time(),
                "row": row,
            }
            threading.Thread(
                target=self._post,
                # the breach flight dump is BUILT on the delivery
                # thread too — evaluate() runs on scrape handlers and
                # the asyncio cadence loop, which must never wait on a
                # crash-dump disk write
                args=(name, payload, status == "breach"),
                name=f"pygrid-slo-webhook-{name}",
                daemon=True,
            ).start()

    @staticmethod
    def _flight_dump(name: str, row: dict) -> dict | None:
        """The flight recorder's crash dump for a breach, inline —
        best-effort (an unwritable flight dir must not kill alerting)."""
        try:
            from pygrid_tpu_torch.telemetry import recorder

            recorder.note("slo.breach", objective=name)
            path = recorder.dump(f"slo_breach_{name}", snapshot=row)
            if path is None:
                return None
            with open(path, encoding="utf-8") as fh:
                return json.load(fh)
        except Exception:  # noqa: BLE001 — alert delivery > dump fidelity
            logger.exception("SLO breach flight dump failed")
            return None

    def _post(
        self, name: str, payload: dict, attach_dump: bool = False
    ) -> None:
        import urllib.request

        if attach_dump:
            payload["flight_dump"] = self._flight_dump(
                name, payload.get("row") or {}
            )
        try:
            req = urllib.request.Request(
                self.url,
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=5) as resp:
                outcome = "ok" if 200 <= resp.status < 300 else "error"
        except Exception:  # noqa: BLE001 — receiver trouble is an outcome
            logger.warning(
                "SLO webhook POST for %s failed", name, exc_info=True
            )
            outcome = "error"
        bus.incr(
            "slo_webhook_posts_total", objective=name, outcome=outcome
        )


class SLOEngine:
    """Evaluates a fixed objective set against the process bus."""

    def __init__(
        self,
        objectives: Iterable[Objective] | None = None,
        windows: tuple[float, ...] | None = None,
        source=None,
    ) -> None:
        self.objectives = list(
            objectives if objectives is not None else node_objectives()
        )
        self.windows = tuple(windows or windows_from_env())
        #: histogram source (the bus module by default; tests inject)
        self._source = source if source is not None else bus
        #: push-side alerting: one POST per objective status transition
        #: (no-op unless PYGRID_SLO_WEBHOOK_URL is set — §6)
        self.notifier = BreachNotifier()
        self._lock = threading.Lock()
        self._snaps: deque[_Snapshot] = deque(maxlen=MAX_SNAPSHOTS)
        #: minimum spacing between RETAINED snapshots: evaluate() ticks
        #: on every read (scrapes, dashboards), and unthrottled appends
        #: would evict the ring in ~30 min of 5 s polling — silently
        #: shrinking the long burn window. Rapid ticks collapse into
        #: the previous snapshot instead, so the ring always spans at
        #: least ~2× the longest window.
        self._min_gap_s = max(self.windows) / (MAX_SNAPSHOTS // 2)
        #: last status seen per objective + the transition log the storm
        #: harness reads to time reactions ("when did ttft flip to
        #: breach?") — webhook delivery state lives in the notifier and
        #: has retry semantics; this log records every flip exactly once
        self._status_seen: dict[str, str] = {}
        self._transitions: deque[dict] = deque(maxlen=MAX_TRANSITIONS)

    # ── collection ──────────────────────────────────────────────────────

    def _totals(self) -> dict[str, dict[str, tuple[int, int]]]:
        hists = self._source.histograms()
        out: dict[str, dict[str, tuple[int, int]]] = {}
        for obj in self.objectives:
            groups: dict[str, tuple[int, int]] = {}
            for (name, label_items), snap in hists.items():
                if name != obj.family:
                    continue
                labels = dict(label_items)
                if obj.labels and any(
                    labels.get(k) != v for k, v in obj.labels.items()
                ):
                    continue
                good = _good_count(snap, obj.threshold_s)
                count = snap["count"]
                keys = [""]  # "": the ungrouped aggregate
                if obj.group_by:
                    group_value = labels.get(obj.group_by)
                    if group_value:
                        keys.append(str(group_value))
                for key in keys:
                    c, g = groups.get(key, (0, 0))
                    groups[key] = (c + count, g + good)
            out[obj.name] = groups or {"": (0, 0)}
        return out

    def tick(self, now: float | None = None) -> None:
        """Append one snapshot (call on a cadence; also called by
        :meth:`evaluate` so an idle process still self-snapshots).
        A tick landing within ``_min_gap_s`` of the previous snapshot
        REPLACES it (newest data, same ring slot) unless it is the only
        anchor — read-driven ticking cannot erode window history."""
        snap = _Snapshot(
            ts=now if now is not None else time.monotonic(),
            totals=self._totals(),
        )
        with self._lock:
            # the last snapshot earns a permanent slot once it is
            # min_gap from the one before it; until then rapid ticks
            # refresh it in place
            if (
                len(self._snaps) >= 2
                and snap.ts - self._snaps[-2].ts < self._min_gap_s
            ):
                self._snaps[-1] = snap
            else:
                self._snaps.append(snap)

    # ── evaluation ──────────────────────────────────────────────────────

    def _window_delta(
        self, name: str, window: float, now: float
    ) -> tuple[int, int]:
        """(count, good) accrued inside ``[now - window, now]``."""
        with self._lock:
            snaps = list(self._snaps)
        if not snaps:
            return (0, 0)
        newest = snaps[-1].totals.get(name, {})
        cur = _sum_groups(newest)
        base: tuple[int, int] = (0, 0)
        for snap in snaps:
            if snap.ts >= now - window:
                base = _sum_groups(snap.totals.get(name, {}))
                break
        return (cur[0] - base[0], cur[1] - base[1])

    @staticmethod
    def _burn(delta: tuple[int, int], budget: float) -> float | None:
        count, good = delta
        if count <= 0:
            return None
        return ((count - good) / count) / budget

    def evaluate(self, now: float | None = None) -> list[dict]:
        """Tick, then score every objective — the ``/telemetry/slo``
        payload (see module docstring for the status policy)."""
        now = now if now is not None else time.monotonic()
        self.tick(now)
        out = []
        for obj in self.objectives:
            with self._lock:
                newest = self._snaps[-1].totals.get(obj.name, {})
            count, good = _sum_groups(newest)
            compliance = good / count if count else None
            burns: dict[str, float | None] = {}
            window_counts: dict[str, int] = {}
            # short-to-long regardless of PYGRID_SLO_WINDOWS order —
            # the dashboard's burn columns read this dict positionally
            for window in sorted(self.windows):
                label = _window_label(window)
                delta = self._window_delta(obj.name, window, now)
                window_counts[label] = delta[0]
                burns[label] = self._burn(delta, obj.budget)
            status = self._status(obj, compliance, burns, window_counts)
            self._note_transition(obj, status, now)
            row = {
                "name": obj.name,
                "family": obj.family,
                "description": obj.description,
                "threshold_s": obj.threshold_s,
                "target": obj.target,
                "events": count,
                "compliance": compliance,
                "burn": burns,
                "status": status,
            }
            if obj.group_by:
                row["by_" + obj.group_by] = self.group_burn(obj.name, now)
            out.append(row)
        try:
            self.notifier.observe(out)
        except Exception:  # noqa: BLE001 — alerting must not break reads
            logger.exception("SLO webhook notifier failed")
        return out

    def _note_transition(self, obj: Objective, status: str, now: float) -> None:
        """Log a status flip, and when an objective flips INTO breach
        while a deliberate fault is marked, observe injection→detection
        as ``slo_breach_detect_seconds`` (the reaction-latency metric)."""
        with self._lock:
            prev = self._status_seen.get(obj.name)
            if status == prev:
                return
            self._status_seen[obj.name] = status
            self._transitions.append(
                {
                    "name": obj.name,
                    "from": prev,
                    "to": status,
                    "ts": now,
                    "wall_ts": time.time(),
                }
            )
        if status == "breach" and prev != "breach":
            fault_ts = last_fault_ts()
            if fault_ts is not None and now >= fault_ts:
                self._source.observe(
                    "slo_breach_detect_seconds",
                    now - fault_ts,
                    objective=obj.name,
                )

    def transitions(self) -> list[dict]:
        """Status flips, oldest first (bounded by MAX_TRANSITIONS)."""
        with self._lock:
            return list(self._transitions)

    def _status(
        self,
        obj: Objective,
        compliance: float | None,
        burns: dict[str, float | None],
        window_counts: dict[str, int],
    ) -> str:
        if compliance is None:
            return "no_data"
        values = [b for b in burns.values() if b is not None]
        short_label = _window_label(min(self.windows))
        short = burns.get(short_label)
        long_ = burns.get(_window_label(max(self.windows)))
        # breach is WINDOWED-BURN ONLY (with MIN_EVENTS of supporting
        # traffic): lifetime compliance is cumulative and never resets,
        # so a breach rule on it would latch deep /healthz at 503 for
        # hours after an incident ends — a recovered objective must
        # read as recovered once the burn windows clear
        if (
            short is not None
            and short >= PAGE_BURN
            and window_counts.get(short_label, 0) >= MIN_EVENTS
            and (long_ is None or long_ > CONFIRM_BURN)
        ):
            return "breach"
        if any(b > 1.0 for b in values) or compliance < obj.target:
            return "warn"
        return "ok"

    def group_burn(
        self,
        name: str,
        now: float | None = None,
        min_events: int = 0,
    ) -> dict[str, float]:
        """Short-window burn per group value for a grouped objective —
        the network monitor's per-node degradation signal. Groups with
        fewer than ``min_events`` observations in the window are
        omitted: one slow heartbeat from a freshly joined node is not
        a degradation verdict."""
        now = now if now is not None else time.monotonic()
        obj = next((o for o in self.objectives if o.name == name), None)
        if obj is None or not obj.group_by:
            return {}
        window = min(self.windows)
        with self._lock:
            snaps = list(self._snaps)
        if not snaps:
            return {}
        newest = snaps[-1].totals.get(name, {})
        base: dict[str, tuple[int, int]] = {}
        for snap in snaps:
            if snap.ts >= now - window:
                base = snap.totals.get(name, {})
                break
        out: dict[str, float] = {}
        for group, (count, good) in newest.items():
            if not group:
                continue
            b_count, b_good = base.get(group, (0, 0))
            delta = (count - b_count, good - b_good)
            if delta[0] < min_events:
                continue
            burn = self._burn(delta, obj.budget)
            if burn is not None:
                out[group] = burn
        return out

    def healthy(self) -> bool:
        """The deep-health verdict: no objective in breach."""
        return all(
            row["status"] != "breach" for row in self.evaluate()
        )

    def export(self, exp) -> None:
        """SLO gauges for ``/metrics``: compliance and per-window burn
        per objective (documented in docs/OBSERVABILITY.md §8)."""
        for row in self.evaluate():
            labels = {"slo": row["name"]}
            if row["compliance"] is not None:
                exp.gauge(
                    "slo_compliance", row["compliance"],
                    "fraction of events meeting the objective", labels,
                )
            for window, burn in row["burn"].items():
                if burn is not None:
                    exp.gauge(
                        "slo_burn_rate", burn,
                        "error-budget burn rate, by window",
                        {**labels, "window": window},
                    )

    def reset(self) -> None:
        with self._lock:
            self._snaps.clear()


def _sum_groups(groups: dict[str, tuple[int, int]]) -> tuple[int, int]:
    entry = groups.get("")
    if entry is not None:
        return entry
    count = sum(c for c, _ in groups.values())
    good = sum(g for _, g in groups.values())
    return (count, good)


def _window_label(window: float) -> str:
    if window % 3600 == 0:
        return f"{int(window // 3600)}h"
    if window % 60 == 0:
        return f"{int(window // 60)}m"
    return f"{int(window)}s"
