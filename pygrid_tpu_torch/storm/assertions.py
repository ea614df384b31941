"""Reaction assertions: the storm's verdicts — the port's counterpart of
:mod:`pygrid_tpu.storm.assertions`, with the same verdict names, detail
texts and ``measured`` keys (a replay compares verdicts across stacks).

Each check judges the system's *reaction* to injected faults — not mere
survival — from four evidence streams: the op log (organic traffic
outcomes), the fault injector's event log, the watcher timeline
(SLO statuses / proxy states / placement at monitor cadence), and
in-process handles (SLO transition log, leak ledgers, subagg stats).

Verdicts are designed to be DETERMINISTIC for a fixed scenario seed:
they assert ordering and bounded reaction windows, never exact
latencies, so a replay of a storm dump reproduces the same verdict set
(the replay contract, storm/replay.py).
"""

from __future__ import annotations

import dataclasses

from pygrid_tpu_torch.telemetry import bus


@dataclasses.dataclass
class Verdict:
    name: str
    ok: bool
    detail: str = ""
    measured: dict = dataclasses.field(default_factory=dict)


def run_checks(spec, topology, ops, injector, timeline) -> list:
    ctx = _CheckContext(spec, topology, ops, injector, timeline)
    out = []
    for name in spec.checks:
        check = getattr(ctx, f"check_{name}")
        try:
            out.append(check())
        except Exception as err:  # noqa: BLE001 — a crashed check is a
            # failed verdict with the crash as evidence, not a crashed
            # storm run
            out.append(
                Verdict(name=name, ok=False, detail=f"check crashed: {err!r}")
            )
    return out


class _CheckContext:
    def __init__(self, spec, topology, ops, injector, timeline) -> None:
        self.spec = spec
        self.topology = topology
        self.ops = ops
        self.injector = injector
        self.timeline = timeline

    def _params(self, check: str) -> dict:
        return self.spec.check_params.get(check, {})

    # ── traffic ─────────────────────────────────────────────────────────

    def check_served_traffic(self) -> Verdict:
        """Every leg served real traffic, and nothing failed outside
        the expected open-loop outcomes (busy under load, typed stale
        cycle rejections). Fault-generated burst requests may be busy,
        but must never error."""
        counts: dict[str, dict[str, int]] = {}
        errors = []
        for rec in self.ops:
            leg = counts.setdefault(rec.leg, {})
            leg[rec.outcome] = leg.get(rec.outcome, 0) + 1
            if rec.outcome == "error":
                errors.append(f"{rec.leg}#{rec.index}: {rec.detail}")
        for fo in self.injector.fault_ops:
            if fo["outcome"] == "error":
                errors.append(f"burst#{fo['index']}: {fo['detail']}")
        missing = [
            t.leg for t in self.spec.traffic
            if counts.get(t.leg, {}).get("ok", 0) < 1
        ]
        ok = not errors and not missing
        detail = "; ".join(
            (["legs without an ok op: " + ",".join(missing)] if missing
             else [])
            + errors[:5]
        )
        return Verdict(
            "served_traffic", ok, detail, {"ops": counts}
        )

    # ── SLO reaction ────────────────────────────────────────────────────

    def _breach_transitions(self) -> list[dict]:
        return [
            t for t in self.topology.node_ctx(0).slo.transitions()
            if t["to"] == "breach"
        ]

    def check_breach_detected(self) -> Verdict:
        """A breach-capable fault was injected and the SLO engine
        flipped an objective into ``breach`` within ``max_detect_s`` of
        the newest injection before it — and the reaction was measured
        into the ``slo_breach_detect_seconds`` histogram."""
        max_detect = float(self._params("breach_detected").get(
            "max_detect_s", 5.0
        ))
        applied = [
            ev for ev in self.injector.events
            if ev["phase"] == "apply" and "applied_mono" in ev
            and ev["kind"] in (
                "exhaust_blocks", "saturate_queue", "slow_node",
                "slow_link",
            )
        ]
        if not applied:
            return Verdict(
                "breach_detected", False,
                "no breach-capable fault was applied",
            )
        breaches = self._breach_transitions()
        first_inject = min(ev["applied_mono"] for ev in applied)
        hits = [t for t in breaches if t["ts"] >= first_inject]
        if not hits:
            return Verdict(
                "breach_detected", False,
                f"no breach transition after injection "
                f"(transitions: {len(breaches)})",
            )
        first = hits[0]
        # measure against the newest injection at/before detection —
        # the same rule the slo engine's fault clock applies
        basis = max(
            ev["applied_mono"] for ev in applied
            if ev["applied_mono"] <= first["ts"]
        )
        detect_s = first["ts"] - basis
        hist_count = sum(
            snap["count"]
            for (name, _labels), snap in bus.histograms().items()
            if name == "slo_breach_detect_seconds"
        )
        ok = detect_s <= max_detect and hist_count >= 1
        return Verdict(
            "breach_detected", ok,
            "" if ok else (
                f"detect latency {detect_s:.2f}s (max {max_detect}s), "
                f"histogram count {hist_count}"
            ),
            {
                "detect_s": round(detect_s, 3),
                "objective": first["name"],
                "histogram_count": hist_count,
            },
        )

    def check_recovery(self) -> Verdict:
        """After faults clear and the burn windows drain, the system is
        back in compliance: every breach transition was followed by an
        exit, and the engine ends the run with no objective in breach
        (= the deep-health verdict)."""
        slo = self.topology.node_ctx(0).slo
        transitions = slo.transitions()
        breaches = [t for t in transitions if t["to"] == "breach"]
        if breaches:
            last_breach = breaches[-1]["ts"]
            exits = [
                t for t in transitions
                if t["from"] == "breach" and t["ts"] > last_breach
            ]
            if not exits:
                return Verdict(
                    "recovery", False,
                    "still in breach: no exit transition after the "
                    "last breach",
                )
        healthy = slo.healthy()
        return Verdict(
            "recovery", healthy,
            "" if healthy else "an objective is still in breach",
            {"breach_count": len(breaches)},
        )

    # ── leaks ───────────────────────────────────────────────────────────

    def check_leak_free(self) -> Verdict:
        """Zero stuck slots/cycles/blocks after drain: every node's
        serving ledger balances (free + cached == usable once drained,
        chaos holds returned), admission queues are empty, and no
        surviving sub-aggregator is sitting on buffered folds."""
        problems = []
        ledgers = []
        for i in range(len(self.topology.nodes)):
            ledger = self.topology.node_ctx(i).serving.ledger()
            ledgers.append(ledger)
            if not ledger["balanced"]:
                problems.append(f"node {i} ledger unbalanced: {ledger}")
            for led in ledger["engines"]:
                if led["queue_depth"] or led["live_slots"]:
                    problems.append(
                        f"node {i} engine {led['model_id']} not "
                        f"drained: queue={led['queue_depth']} "
                        f"live={led['live_slots']}"
                    )
                if led.get("chaos_held"):
                    problems.append(
                        f"node {i} engine {led['model_id']} still "
                        f"holds {led['chaos_held']} chaos blocks"
                    )
        for server in self.topology.live_subaggs():
            stats = server.app["subagg"].stats()
            if stats["buffered"]:
                problems.append(
                    f"subagg {stats['id']} buffered folds: "
                    f"{stats['buffered']}"
                )
        return Verdict(
            "leak_free", not problems, "; ".join(problems[:5]),
            {"ledgers": ledgers},
        )

    # ── topology reaction ───────────────────────────────────────────────

    def check_routes_around_subagg(self) -> Verdict:
        """After the kill, placement stopped naming the dead
        sub-aggregator within a bounded reaction window, and FL traffic
        kept completing (surviving subagg or the direct fallback)."""
        max_react = float(self._params("routes_around_subagg").get(
            "max_react_s", 3.0
        ))
        ev = self.injector.applied("kill_subagg")
        if ev is None:
            return Verdict(
                "routes_around_subagg", False, "kill_subagg never fired"
            )
        dead_ids = [
            s.app["subagg"].id
            for s in self.topology.subaggs
            if not s.alive()
        ]
        if not dead_ids:
            return Verdict(
                "routes_around_subagg", False,
                "no subagg is actually dead",
            )
        killed_s = ev["fired_s"]
        routed_s = None
        for sample in self.timeline:
            if sample["t_s"] < killed_s or "placement" not in sample:
                continue
            if not any(d in sample["placement"] for d in dead_ids):
                routed_s = sample["t_s"]
                break
        fl_after = [
            r for r in self.ops
            if r.leg == "fl" and r.start_s > killed_s
        ]
        fl_ok = sum(1 for r in fl_after if r.outcome == "ok")
        fl_err = [r for r in fl_after if r.outcome == "error"]
        ok = (
            routed_s is not None
            and routed_s - killed_s <= max_react
            and fl_ok >= 1
            and not fl_err
        )
        return Verdict(
            "routes_around_subagg", ok,
            "" if ok else (
                f"routed_s={routed_s} killed_s={killed_s:.2f} "
                f"fl_ok={fl_ok} fl_errors={len(fl_err)}"
            ),
            {
                "react_s": (
                    round(routed_s - killed_s, 3)
                    if routed_s is not None else None
                ),
                "fl_ok_after_kill": fl_ok,
            },
        )

    def check_degraded_routing(self) -> Verdict:
        """The slow node flips to ``degraded`` in the network monitor
        while the fault stands, and returns to ``online`` once good
        heartbeats dilute the burn window."""
        ev = self.injector.applied("slow_node")
        if ev is None:
            return Verdict(
                "degraded_routing", False, "slow_node never fired"
            )
        applied_s = ev["fired_s"]
        degraded_s = None
        recovered = False
        for sample in self.timeline:
            proxies = sample.get("proxies") or {}
            any_degraded = any(
                p["status"] == "degraded" for p in proxies.values()
            )
            if sample["t_s"] >= applied_s and any_degraded and (
                degraded_s is None
            ):
                degraded_s = sample["t_s"]
            if degraded_s is not None and sample["t_s"] > degraded_s:
                if proxies and not any_degraded and all(
                    p["status"] == "online" for p in proxies.values()
                ):
                    recovered = True
        ok = degraded_s is not None and recovered
        return Verdict(
            "degraded_routing", ok,
            "" if ok else (
                f"degraded_s={degraded_s} recovered={recovered}"
            ),
            {
                "react_s": (
                    round(degraded_s - applied_s, 3)
                    if degraded_s is not None else None
                )
            },
        )

    def check_poison_rejected(self) -> Verdict:
        """Every hostile frame bounced with a TYPED error — none was
        accepted, none crashed its connection."""
        results = self.injector.poison_results
        if not results:
            return Verdict(
                "poison_rejected", False, "no poison frames were sent"
            )
        bad = [
            r for r in results
            if r.get("crashed") or r.get("accepted")
            or not r.get("error")
        ]
        return Verdict(
            "poison_rejected", not bad,
            "; ".join(str(r) for r in bad[:3]),
            {"frames": len(results)},
        )
