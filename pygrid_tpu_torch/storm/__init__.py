"""gridstorm on the port: open-loop load generation, fault injection, and
replay — the counterpart of :mod:`pygrid_tpu.storm`.

Every resilience mechanism in the grid — the SLO
engine and its breach webhooks, degraded-node routing, sub-aggregator
expiry + direct-report fallback, the paged-KV leak ledger, the flight
recorder — is exercised here under one roof, against a REAL topology
(the port's own HTTP/WebSocket servers on localhost event-loop threads,
real websockets, the same codepaths production runs, the nodes' tensors
on the card), and the harness asserts the system's
*reaction*, not just its survival:

- a deliberately injected fault is detected as an SLO breach within a
  bounded number of monitor ticks (``slo_breach_detect_seconds``),
- the monitor flips a slow node to ``degraded`` and placement routes
  around a killed sub-aggregator (workers fall back to direct reports),
- the system returns to compliance after the fault clears, and
- the leak ledgers balance — zero stuck slots, cycles, or KV blocks.

The modules (the JAX package's docs/STORM.md):

- :mod:`pygrid_tpu_torch.storm.scenarios` — declarative scenario specs
  (dict/YAML, deterministic seed) + the built-in registry,
- :mod:`pygrid_tpu_torch.storm.loadgen` — the open-loop traffic engine and
  topology builder (:class:`~pygrid_tpu_torch.storm.loadgen.StormHarness`),
- :mod:`pygrid_tpu_torch.storm.faults` — the fault plane, scheduled on the
  scenario clock,
- :mod:`pygrid_tpu_torch.storm.assertions` — reaction verdicts over the run,
- :mod:`pygrid_tpu_torch.storm.replay` — re-drive a flight-recorder dump
  captured during a storm as a regression scenario.

CLI: ``python -m pygrid_tpu_torch.storm --scenario smoke`` (the nodes on
the card; ``--device cpu`` on a host without a GPU).
"""

from __future__ import annotations

from pygrid_tpu_torch.storm.scenarios import (  # noqa: F401
    FaultSpec,
    StormScenario,
    TrafficSpec,
    builtin_scenarios,
    get_scenario,
)

__all__ = [
    "FaultSpec",
    "StormScenario",
    "TrafficSpec",
    "builtin_scenarios",
    "get_scenario",
]
