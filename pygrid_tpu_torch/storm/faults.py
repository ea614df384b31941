"""The fault plane: scheduled injection against live topology handles —
the port's counterpart of :mod:`pygrid_tpu.storm.faults`.

Each fault manipulates the system through a narrow, documented failpoint
(`chaos_*` hooks, the wire shim, registry clock back-dating) — never by
bypassing production code. Faults that can plausibly cause an SLO breach
mark the injection instant on the SLO fault clock
(:func:`pygrid_tpu_torch.telemetry.slo.mark_fault`), which is what turns a
later breach transition into a ``slo_breach_detect_seconds`` reaction
sample. Marks stand until harness teardown: within one storm, any breach
after injection is attributable to the newest injected fault.

Catalogue (the JAX package's docs/STORM.md):

===============  ========================================================
kind             effect
===============  ========================================================
kill_subagg      stop the sub-aggregator's server mid-cycle AND
                 back-date its registry heartbeat (AggregationRegistry
                 .expire) so placement reacts this tick, not a TTL later
exhaust_blocks   chaos-hold every free KV block
                 (GenerationEngine.chaos_hold_blocks) for duration_s —
                 admission parks, the queue backs up, TTFT explodes
saturate_queue   an open burst of generation requests into the
                 admission queue; overflow bounces typed ServerBusy
slow_node        inject delay into the node's monitor-heartbeat
                 endpoint (NodeContext.chaos_status_delay_s) — the
                 network must flip the node to ``degraded``
slow_link        delay every client WS data frame
                 (ws_transport.CHAOS_HOOK)
poison_reports   hostile report/partial frames at the node and a live
                 sub-aggregator — every one must bounce TYPED
===============  ========================================================
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np

from pygrid_tpu_torch.telemetry import recorder
from pygrid_tpu_torch.telemetry import slo as slo_mod

logger = logging.getLogger(__name__)

#: fault kinds that can plausibly drive an SLO breach — these mark the
#: fault clock; topology manipulations that cannot breach do not
_BREACH_CAPABLE = (
    "exhaust_blocks", "saturate_queue", "slow_node", "slow_link",
)


class FaultInjector:
    """Fires the scenario's fault schedule on its own thread. ``events``
    records what actually happened (apply/clear times on the scenario
    clock) for the assertions; ``fault_ops`` and ``poison_results``
    collect the responses of fault-generated requests, which are judged
    by different rules than organic traffic."""

    def __init__(self, topology, scenario, t0: float) -> None:
        self.topology = topology
        self.scenario = scenario
        self.t0 = t0
        self.events: list[dict] = []
        self.fault_ops: list[dict] = []
        self.poison_results: list[dict] = []
        self._lock = threading.Lock()
        self._burst_threads: list[threading.Thread] = []
        self._schedule: list[tuple[float, str, object, object]] = []
        for fault in scenario.faults:
            apply_fn, clear_fn = self._build(fault)
            self._schedule.append((fault.at_s, "apply", fault, apply_fn))
            if clear_fn is not None and fault.duration_s > 0:
                self._schedule.append(
                    (fault.at_s + fault.duration_s, "clear", fault,
                     clear_fn)
                )
        self._schedule.sort(key=lambda e: e[0])
        self._thread = threading.Thread(
            target=self._run, name="storm-faults", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def join(self, timeout: float) -> None:
        self._thread.join(timeout=timeout)
        deadline = time.monotonic() + 10.0
        for t in self._burst_threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))

    def _run(self) -> None:
        for at_s, phase, fault, fn in self._schedule:
            delay = self.t0 + at_s - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            now_s = time.monotonic() - self.t0
            try:
                fn()
            except Exception as err:  # noqa: BLE001 — recorded verdict
                logger.exception("fault %s %s failed", fault.kind, phase)
                with self._lock:
                    self.events.append(
                        {
                            "kind": fault.kind, "phase": phase,
                            "at_s": at_s, "fired_s": now_s,
                            "failed": repr(err),
                        }
                    )
                continue
            if phase == "apply" and fault.kind in _BREACH_CAPABLE:
                slo_mod.mark_fault(fault.kind)
            recorder.note(
                "storm.fault", kind=fault.kind, phase=phase, at_s=at_s
            )
            with self._lock:
                self.events.append(
                    {
                        "kind": fault.kind, "phase": phase, "at_s": at_s,
                        "fired_s": now_s,
                        "applied_mono": time.monotonic(),
                    }
                )

    # ── fault builders ──────────────────────────────────────────────────

    def _build(self, fault):
        builder = getattr(self, f"_build_{fault.kind}")
        return builder(fault)

    def _target_index(self, fault) -> int:
        return int(fault.target) if fault.target is not None else 0

    def _build_kill_subagg(self, fault):
        def apply() -> None:
            server = self.topology.subaggs[self._target_index(fault)]
            sid = server.app["subagg"].id
            # mid-cycle: buffered folds flush on cleanup (the port's
            # BackgroundServer.stop runs every on_cleanup hook)
            server.stop()
            # back-date the heartbeat so expiry lands THIS monitor tick
            self.topology.network_ctx.aggregation.expire(sid)

        return apply, None

    def _build_exhaust_blocks(self, fault):
        from pygrid_tpu_torch.storm.loadgen import GEN_MODEL_ID

        def _engine():
            serving = self.topology.node_ctx(
                self._target_index(fault)
            ).serving
            engine = serving.engines().get(GEN_MODEL_ID)
            if engine is None:
                raise RuntimeError("generation engine not built yet")
            return engine

        def apply() -> None:
            held = _engine().chaos_hold_blocks(None)
            logger.info("exhaust_blocks: holding %d blocks", held)

        def clear() -> None:
            _engine().chaos_release_blocks()

        return apply, clear

    def _build_saturate_queue(self, fault):
        from pygrid_tpu_torch.storm.loadgen import GEN_MODEL_ID

        burst = int(fault.params.get("burst", 24))
        n_new = int(fault.params.get("n_new", 24))
        node = self.topology.nodes[self._target_index(fault)]

        def one(i: int) -> None:
            from pygrid_tpu_torch.client import DataCentricFLClient

            outcome = "ok"
            detail = ""
            try:
                client = DataCentricFLClient(
                    node.url, device=self.topology.device
                )
                try:
                    client.run_remote_generation(
                        GEN_MODEL_ID,
                        np.array([[1, 2, 3, (5 + i) % 31]], np.int32),
                        n_new=n_new,
                    )
                finally:
                    client.close()
            except Exception as err:  # noqa: BLE001 — judged later
                low = str(err).lower()
                busy = (
                    "busy" in low or "queue full" in low
                    or "exhausted" in low
                )
                outcome = "busy" if busy else "error"
                detail = str(err)
            with self._lock:
                self.fault_ops.append(
                    {"fault": "saturate_queue", "index": i,
                     "outcome": outcome, "detail": detail}
                )

        def apply() -> None:
            for i in range(burst):
                t = threading.Thread(
                    target=one, args=(i,),
                    name=f"storm-burst-{i}", daemon=True,
                )
                self._burst_threads.append(t)
                t.start()

        return apply, None

    def _build_slow_node(self, fault):
        delay_s = float(fault.params.get("delay_s", 0.5))
        ctx = None

        def apply() -> None:
            nonlocal ctx
            ctx = self.topology.node_ctx(self._target_index(fault))
            ctx.chaos_status_delay_s = delay_s

        def clear() -> None:
            if ctx is not None:
                ctx.chaos_status_delay_s = 0.0

        return apply, clear

    def _build_slow_link(self, fault):
        from pygrid_tpu_torch.client import ws_transport

        delay_s = float(fault.params.get("delay_s", 0.02))

        def hook(direction: str, nbytes: int) -> None:
            if direction == "send":
                time.sleep(delay_s)

        def apply() -> None:
            ws_transport.CHAOS_HOOK = hook

        def clear() -> None:
            ws_transport.CHAOS_HOOK = None

        return apply, clear

    def _build_poison_reports(self, fault):
        def apply() -> None:
            from pygrid_tpu_torch.client.base import GridWSClient
            from pygrid_tpu_torch.utils.codes import MODEL_CENTRIC_FL_EVENTS

            results = []

            def probe(ws, label: str, event, **data) -> None:
                try:
                    out = ws.send_msg_binary(event, data=data)
                    payload = out.get("data", out)
                    results.append(
                        {
                            "frame": label,
                            "error": payload.get("error"),
                            "accepted": payload.get("status")
                            == "success",
                        }
                    )
                except Exception as err:  # noqa: BLE001 — a poison
                    # frame crashing the CONNECTION (vs a typed bounce)
                    # is exactly the failure poison_rejected catches
                    results.append(
                        {"frame": label, "crashed": repr(err)}
                    )

            node_ws = GridWSClient(
                self.topology.nodes[0].url, offer_wire_v2=True
            )
            try:
                probe(
                    node_ws, "partial-zero-count",
                    MODEL_CENTRIC_FL_EVENTS.REPORT_PARTIAL,
                    workers=[], count=0, diff="AAAA",
                )
                probe(
                    node_ws, "partial-count-mismatch",
                    MODEL_CENTRIC_FL_EVENTS.REPORT_PARTIAL,
                    workers=[["w-x", "k-x"]], count=3, diff="AAAA",
                )
                probe(
                    node_ws, "partial-bad-key",
                    MODEL_CENTRIC_FL_EVENTS.REPORT_PARTIAL,
                    workers=[["w-x", "not-a-real-assignment"]],
                    count=1, diff="AAAA",
                )
            finally:
                node_ws.close()
            live = self.topology.live_subaggs()
            if live:
                sub_ws = GridWSClient(live[0].url, offer_wire_v2=True)
                try:
                    probe(
                        sub_ws, "subagg-garbage-report",
                        MODEL_CENTRIC_FL_EVENTS.REPORT,
                        diff="!!not-base64!!",
                    )
                finally:
                    sub_ws.close()
            with self._lock:
                self.poison_results.extend(results)

        return apply, None

    # ── accessors for the assertions ────────────────────────────────────

    def applied(self, kind: str) -> dict | None:
        with self._lock:
            for ev in self.events:
                if ev["kind"] == kind and ev["phase"] == "apply" and (
                    "failed" not in ev
                ):
                    return ev
        return None
