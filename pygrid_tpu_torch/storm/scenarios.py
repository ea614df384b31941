"""Declarative storm scenarios — the port's counterpart of
:mod:`pygrid_tpu.storm.scenarios`.

A scenario is pure data: topology sizes, per-leg open-loop traffic
(arrival rates on the scenario clock), a fault schedule, env knobs, and
the list of reaction checks to assert afterwards. It round-trips
through plain dicts (and YAML when available) and carries a seed, so a
run — and a replay of its flight-recorder dump — re-derives the exact
same arrival and fault schedule.

The scenario dict IS the replay contract: it is embedded verbatim in
the storm's flight dump (under ``snapshot.storm.scenario``), so field
names must stay stable and must not collide with the recorder's
redaction markers (telemetry/recorder.py ``_REDACT_KEYS``). The fields,
seeds, rates, fault times and ``env`` knobs are the reference's, key for
key: a dump written by either package's harness replays in the other's.
"""

from __future__ import annotations

import dataclasses
#: fault kinds the fault plane implements (storm/faults.py)
FAULT_KINDS = (
    "kill_subagg",      # stop the sub-aggregator server + expire placement
    "exhaust_blocks",   # chaos-hold every free KV block for duration_s
    "saturate_queue",   # burst generation requests into the admission queue
    "slow_node",        # delay the node's monitor heartbeat endpoint
    "slow_link",        # delay every client WS data frame (wire shim)
    "poison_reports",   # hostile/malformed report + partial frames
)

#: traffic legs the load generator implements (storm/loadgen.py)
TRAFFIC_LEGS = ("fl", "generation", "datacentric", "smpc")

#: reaction checks the assertion engine implements (storm/assertions.py)
CHECKS = (
    "served_traffic",
    "breach_detected",
    "recovery",
    "leak_free",
    "routes_around_subagg",
    "degraded_routing",
    "poison_rejected",
)


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: ``kind`` fires at ``at_s`` on the scenario
    clock and (when it has an extent) clears at ``at_s + duration_s``."""

    kind: str
    at_s: float
    duration_s: float = 0.0
    target: str | None = None  # node/subagg name; None → the first one
    params: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TrafficSpec:
    """One open-loop traffic leg: Poisson arrivals at ``rate_hz`` from
    ``start_s`` until ``stop_s`` (scenario end when None)."""

    leg: str
    rate_hz: float
    start_s: float = 0.0
    stop_s: float | None = None
    params: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class StormScenario:
    name: str
    duration_s: float
    seed: int = 7
    workers: int = 8          # distinct FL worker identities
    nodes: int = 1
    subaggs: int = 1
    traffic: list = dataclasses.field(default_factory=list)
    faults: list = dataclasses.field(default_factory=list)
    checks: list = dataclasses.field(default_factory=list)
    #: env overrides applied for the run and restored afterwards —
    #: the SLO window / threshold knobs live here so a scenario's
    #: breach math is part of its spec
    env: dict = dataclasses.field(default_factory=dict)
    monitor_interval_s: float = 0.1
    agg_ttl_s: float = 1.0
    #: drain tail after traffic stops: queued work completes, the SLO
    #: watcher keeps ticking so recovery transitions land
    settle_s: float = 4.0
    #: per-check parameter overrides, e.g. breach_detected max_detect_s
    check_params: dict = dataclasses.field(default_factory=dict)

    # ── validation ──────────────────────────────────────────────────────

    def validate(self) -> "StormScenario":
        if self.duration_s <= 0:
            raise ValueError("duration_s must be positive")
        if self.nodes < 1 or self.subaggs < 0 or self.workers < 1:
            raise ValueError("topology sizes must be positive")
        for t in self.traffic:
            if t.leg not in TRAFFIC_LEGS:
                raise ValueError(f"unknown traffic leg {t.leg!r}")
            if t.rate_hz <= 0:
                raise ValueError(f"{t.leg}: rate_hz must be positive")
        for f in self.faults:
            if f.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {f.kind!r}")
            if not 0 <= f.at_s <= self.duration_s:
                raise ValueError(
                    f"{f.kind}: at_s outside the scenario clock"
                )
        for c in self.checks:
            if c not in CHECKS:
                raise ValueError(f"unknown check {c!r}")
        if self.subaggs < 1 and any(
            f.kind == "kill_subagg" for f in self.faults
        ):
            raise ValueError("kill_subagg needs at least one subagg")
        return self

    # ── serialization (the replay contract) ─────────────────────────────

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["traffic"] = [t.to_dict() for t in self.traffic]
        out["faults"] = [f.to_dict() for f in self.faults]
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "StormScenario":
        data = dict(data)
        data["traffic"] = [
            t if isinstance(t, TrafficSpec) else TrafficSpec(**t)
            for t in data.get("traffic", [])
        ]
        data["faults"] = [
            f if isinstance(f, FaultSpec) else FaultSpec(**f)
            for f in data.get("faults", [])
        ]
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown scenario fields: {sorted(unknown)}")
        return cls(**data).validate()

    @classmethod
    def from_yaml(cls, text: str) -> "StormScenario":
        """Parse a YAML (or JSON — YAML is a superset) scenario spec."""
        try:
            import yaml
        except ImportError:  # no PyYAML beside the card: JSON is YAML too
            import json

            return cls.from_dict(json.loads(text))
        return cls.from_dict(yaml.safe_load(text))


# ── built-in scenarios ──────────────────────────────────────────────────


def _smoke() -> StormScenario:
    """The tier-1 scenario: one node + one subagg, FL + generation +
    data-centric traffic, three fault types (subagg killed mid-cycle,
    KV block-pool exhaustion, admission-queue saturation), ≤ 30 s on
    the CPU twin. The SLO knobs make the breach math explicit: TTFT
    objective at 99% under 0.8 s over (4 s, 20 s) windows. 0.8 s is a
    determinism margin, chosen so organic CPU-twin jitter (GIL, queue
    waits at 2 slots) can never breach pre-fault, while the 2.5 s block
    hold parks every arriving admission long past it — the breach edge
    is attributable to the injection on every run, including replays —
    and the breach clears once the window drains."""
    return StormScenario(
        name="smoke",
        seed=7,
        duration_s=9.0,
        settle_s=5.0,
        workers=8,
        nodes=1,
        subaggs=1,
        monitor_interval_s=0.1,
        agg_ttl_s=1.0,
        env={
            "PYGRID_SLO_WINDOWS": "4,20",
            "PYGRID_SLO_TTFT_S": "0.8",
            "PYGRID_SLO_TTFT_TARGET": "0.99",
            "PYGRID_SERVING_SLOTS": "2",
            "PYGRID_SERVING_QUEUE": "8",
        },
        traffic=[
            TrafficSpec(leg="fl", rate_hz=3.0),
            TrafficSpec(
                leg="generation", rate_hz=3.0,
                params={"n_new": 4, "prefix_len": 8, "suffix_len": 3},
            ),
            TrafficSpec(leg="datacentric", rate_hz=2.0),
        ],
        faults=[
            FaultSpec(kind="kill_subagg", at_s=3.0),
            FaultSpec(kind="exhaust_blocks", at_s=4.5, duration_s=2.5),
            FaultSpec(
                kind="saturate_queue", at_s=4.5,
                params={"burst": 24, "n_new": 24},
            ),
        ],
        checks=[
            "served_traffic",
            "routes_around_subagg",
            "breach_detected",
            "recovery",
            "leak_free",
        ],
        check_params={"breach_detected": {"max_detect_s": 5.0}},
    )


def _full() -> StormScenario:
    """The acceptance scenario: 64 workers, two nodes, two subaggs,
    all four traffic legs, five fault types including a slow node that
    must flip to ``degraded`` and poison reports that must bounce
    typed. Too long for tier-1 — run via the CLI or the ``slow`` test."""
    return StormScenario(
        name="full",
        seed=11,
        duration_s=24.0,
        settle_s=8.0,
        workers=64,
        nodes=2,
        subaggs=2,
        monitor_interval_s=0.1,
        agg_ttl_s=1.0,
        env={
            "PYGRID_SLO_WINDOWS": "4,20",
            "PYGRID_SLO_TTFT_S": "0.8",
            "PYGRID_SLO_TTFT_TARGET": "0.99",
            # heartbeat math (the JAX package's docs/STORM.md): the degraded verdict needs
            # MIN_EVENTS=10 per-node polls inside the short window, and
            # a slow poll stretches the whole sweep — the delay must be
            # small enough that ≥10 delayed sweeps still fit in 4 s
            "PYGRID_SLO_HEARTBEAT_S": "0.1",
            "PYGRID_SERVING_SLOTS": "2",
            "PYGRID_SERVING_QUEUE": "8",
        },
        traffic=[
            TrafficSpec(leg="fl", rate_hz=6.0),
            TrafficSpec(
                leg="generation", rate_hz=4.0,
                params={"n_new": 4, "prefix_len": 8, "suffix_len": 3},
            ),
            TrafficSpec(leg="datacentric", rate_hz=3.0),
            TrafficSpec(leg="smpc", rate_hz=0.5, start_s=1.0),
        ],
        faults=[
            FaultSpec(kind="kill_subagg", at_s=5.0),
            FaultSpec(kind="exhaust_blocks", at_s=8.0, duration_s=2.5),
            FaultSpec(
                kind="saturate_queue", at_s=8.0,
                params={"burst": 24, "n_new": 24},
            ),
            FaultSpec(
                kind="slow_link", at_s=11.0, duration_s=2.0,
                params={"delay_s": 0.02},
            ),
            FaultSpec(
                kind="slow_node", at_s=13.0, duration_s=5.0,
                params={"delay_s": 0.15},
            ),
            FaultSpec(kind="poison_reports", at_s=19.0),
        ],
        checks=[
            "served_traffic",
            "routes_around_subagg",
            "breach_detected",
            "degraded_routing",
            "recovery",
            "leak_free",
            "poison_rejected",
        ],
        check_params={"breach_detected": {"max_detect_s": 5.0}},
    )


_BUILTIN = {"smoke": _smoke, "full": _full}


def builtin_scenarios() -> dict[str, str]:
    """Name → first docstring line, for ``--list``."""
    return {
        name: (fn.__doc__ or "").strip().splitlines()[0]
        for name, fn in _BUILTIN.items()
    }


def get_scenario(name: str) -> StormScenario:
    try:
        return _BUILTIN[name]().validate()
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r} (have: {sorted(_BUILTIN)})"
        ) from None
