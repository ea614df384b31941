"""Flight-recorder replay: a storm dump is a regression scenario — the
port's counterpart of :mod:`pygrid_tpu.storm.replay`.

Every :class:`~pygrid_tpu.storm.loadgen.StormHarness` run ends by
force-dumping a flight record whose snapshot embeds the full scenario
spec and the verdict set. Because the scenario carries its seed and the
traffic/fault schedules are derived deterministically from it, loading
the dump and re-running the scenario regenerates the identical request
mix and fault timeline — and must reproduce the same verdicts. A storm
that found a regression therefore *is* the regression test: file the
dump, replay it in CI.

The dump's top-level shape is the versioned contract documented in
the JAX package's docs/OBSERVABILITY.md §7 (``schema_version``,
telemetry/recorder.py); replay refuses dumps from a different major
schema rather than guessing at their layout. The port's recorder writes
the reference's schema (``SCHEMA_VERSION`` 1), so a dump of either
package's storm loads in the other's.
"""

from __future__ import annotations

import json

from pygrid_tpu_torch.telemetry.recorder import SCHEMA_VERSION


class ReplayError(ValueError):
    """The dump is not a replayable storm record."""


def load_dump(path: str) -> dict:
    """Parse + validate one flight dump; returns the embedded storm
    record ``{"scenario": ..., "verdicts": ..., "metrics": ...}``."""
    with open(path, encoding="utf-8") as fh:
        payload = json.load(fh)
    version = payload.get("schema_version")
    if version != SCHEMA_VERSION:
        raise ReplayError(
            f"dump schema_version {version!r} != supported "
            f"{SCHEMA_VERSION} — refusing to guess at its layout"
        )
    storm = (payload.get("snapshot") or {}).get("storm")
    if not isinstance(storm, dict) or "scenario" not in storm:
        raise ReplayError(
            "dump carries no storm record (snapshot.storm.scenario) — "
            "not a storm dump, or captured by a non-storm trigger"
        )
    return storm


def replay(path: str, device="cuda") -> tuple:
    """Re-run the dump's scenario with its nodes on ``device``; returns
    ``(report, mismatches)``
    where ``mismatches`` lists verdicts whose (name, ok) pair differs
    from the recorded run — empty means the replay reproduced the
    original verdict set."""
    from pygrid_tpu_torch.storm.loadgen import StormHarness
    from pygrid_tpu_torch.storm.scenarios import StormScenario

    storm = load_dump(path)
    scenario = StormScenario.from_dict(storm["scenario"])
    report = StormHarness(scenario, device=device).run()
    recorded = {
        v["name"]: bool(v["ok"]) for v in storm.get("verdicts", [])
    }
    replayed = {v.name: v.ok for v in report.verdicts}
    mismatches = [
        {
            "name": name,
            "recorded": recorded.get(name),
            "replayed": replayed.get(name),
        }
        for name in sorted(set(recorded) | set(replayed))
        if recorded.get(name) != replayed.get(name)
    ]
    return report, mismatches
