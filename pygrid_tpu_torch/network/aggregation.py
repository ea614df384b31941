"""Sub-aggregator registry + worker placement for hierarchical reports.

The Network app owns the aggregation tree's SHAPE (docs/AGGREGATION.md):
sub-aggregators register here (and re-register as a heartbeat), workers
ask ``GET /aggregation/placement`` which address to report to, and the
monitor sweep expires registrations that went silent so a dead
sub-aggregator stops receiving placements within one TTL — its
subtree's workers fall back to direct node reports (the client retries
direct on any sub-aggregator failure, so placement staleness costs
latency, never a lost report).

Placement is stateless consistent hashing: ``hash(worker_id) mod
live_subaggs(node)`` — no per-worker bookkeeping to leak at 10k
workers, and a worker keeps its sub-aggregator across cycles while the
live set is stable. ``PYGRID_AGG_FANOUT`` bounds how many workers each
sub-aggregator should absorb before flushing (the sub-aggregator reads
the same knob); ``PYGRID_AGG_DEPTH`` caps tree depth for deployments
chaining sub-aggregators (a child registers its parent's address as its
upstream ``node-address`` — the registry only ever places one hop).

The port's copy of :mod:`pygrid_tpu.network.aggregation`. The registry
reads time through ``clock`` (default :func:`time.monotonic`), so a test
drives heartbeat loss by advancing an injected clock instead of sleeping
out the TTL.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Callable

from pygrid_tpu_torch import telemetry

#: a registration older than this many seconds is dead for placement —
#: 3× the sub-aggregator's default re-register interval
DEFAULT_TTL_S = 15.0


@dataclass
class SubAggEntry:
    subagg_id: str
    address: str
    node_address: str
    registered_at: float = field(default_factory=time.monotonic)
    last_seen: float = field(default_factory=time.monotonic)


class AggregationRegistry:
    """Live sub-aggregators, grouped by the node (or parent
    sub-aggregator) they forward to."""

    def __init__(
        self,
        ttl_s: float | None = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        from pygrid_tpu_torch.telemetry import bus

        self.clock = clock
        self.ttl_s = (
            ttl_s
            if ttl_s is not None
            else bus.env_float("PYGRID_AGG_TTL_S", DEFAULT_TTL_S)
        )
        self.fanout = bus.env_int("PYGRID_AGG_FANOUT", 64)
        self.depth = bus.env_int("PYGRID_AGG_DEPTH", 2)
        self._entries: dict[str, SubAggEntry] = {}

    def register(
        self, subagg_id: str, address: str, node_address: str
    ) -> SubAggEntry:
        """Register or heartbeat one sub-aggregator (idempotent — the
        sub-aggregator re-POSTs on an interval and each POST refreshes
        ``last_seen``)."""
        now = self.clock()
        entry = self._entries.get(subagg_id)
        if entry is None:
            entry = SubAggEntry(
                subagg_id=str(subagg_id),
                address=str(address).rstrip("/"),
                node_address=str(node_address).rstrip("/"),
                registered_at=now,
                last_seen=now,
            )
            self._entries[subagg_id] = entry
            telemetry.incr(
                "aggregation_subaggs_total", 1, outcome="registered"
            )
        else:
            entry.address = str(address).rstrip("/")
            entry.node_address = str(node_address).rstrip("/")
            entry.last_seen = now
        return entry

    def remove(self, subagg_id: str) -> bool:
        return self._entries.pop(subagg_id, None) is not None

    def expire(self, subagg_id: str) -> bool:
        """FAULT INJECTION (the JAX package's storm harness): back-date one entry's
        heartbeat past the TTL so the registry sees a silent death NOW
        instead of waiting out ``ttl_s`` — the kill-subagg fault uses
        this to make "stops heartbeating" and "loses placement" land in
        the same scenario tick. Production death detection stays purely
        heartbeat-driven; this only manipulates the clock, not the
        expiry logic, so ``live``/``sweep`` exercise their real paths."""
        entry = self._entries.get(subagg_id)
        if entry is None:
            return False
        entry.last_seen = self.clock() - self.ttl_s - 1.0
        return True

    def live(self, node_address: str | None = None) -> list[SubAggEntry]:
        """Placement-eligible entries, optionally for one upstream,
        in stable (id-sorted) order so the hash placement is
        deterministic across queries."""
        cutoff = self.clock() - self.ttl_s
        out = [
            e
            for e in self._entries.values()
            if e.last_seen >= cutoff
            and (
                node_address is None
                or e.node_address == node_address.rstrip("/")
            )
        ]
        return sorted(out, key=lambda e: e.subagg_id)

    def sweep(self) -> list[str]:
        """Expire silent registrations (monitor-loop cadence). Returns
        the expired ids — the heartbeat-loss path of the mid-cycle
        failure story: once expired, no new worker is placed on the
        dead sub-aggregator, and its already-placed workers' direct
        fallback covers the rest."""
        cutoff = self.clock() - self.ttl_s
        dead = [
            sid
            for sid, e in self._entries.items()
            if e.last_seen < cutoff
        ]
        for sid in dead:
            del self._entries[sid]
            telemetry.incr(
                "aggregation_subaggs_total", 1, outcome="expired"
            )
        return dead

    def place(
        self, node_address: str, worker_id: str
    ) -> SubAggEntry | None:
        """The sub-aggregator this worker should report to, or None for
        direct-to-node (the fallback when none are registered)."""
        live = self.live(node_address)
        if not live:
            return None
        digest = hashlib.sha256(str(worker_id).encode()).digest()
        return live[int.from_bytes(digest[:8], "big") % len(live)]

    def stats(self) -> dict:
        """Flight-recorder stats provider: the tree's live shape, so a
        network crash dump (and the periodic engine snapshots) show how
        placement looked before the failure."""
        cutoff = self.clock() - self.ttl_s
        live = sum(
            1 for e in self._entries.values() if e.last_seen >= cutoff
        )
        return {
            "registered": len(self._entries),
            "live": live,
            "fanout": self.fanout,
            "depth": self.depth,
            "ttl_s": self.ttl_s,
        }

    def tree(self) -> dict:
        """The topology snapshot ``GET /aggregation/tree`` serves: live
        sub-aggregators grouped under their upstream, plus the knobs."""
        cutoff = self.clock() - self.ttl_s
        by_upstream: dict[str, list[dict]] = {}
        for e in self._entries.values():
            by_upstream.setdefault(e.node_address, []).append(
                {
                    "id": e.subagg_id,
                    "address": e.address,
                    "live": e.last_seen >= cutoff,
                    "age_s": round(self.clock() - e.last_seen, 3),
                }
            )
        return {
            "fanout": self.fanout,
            "depth": self.depth,
            "ttl_s": self.ttl_s,
            "nodes": by_upstream,
        }
