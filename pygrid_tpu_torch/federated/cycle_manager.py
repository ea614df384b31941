"""CycleManager — cycle lifecycle and the FedAvg aggregation core: the
port's copy of :mod:`pygrid_tpu.federated.cycle_manager`.

Parity surface: reference ``model_centric/cycles/cycle_manager.py``:
``create`` (:28-54), ``last_participation`` (:56), ``assign``/``validate``
(:120,:127), ``submit_worker_diff`` (:151-178), ``complete_cycle`` readiness
(:180-217), ``_average_plan_diffs`` (:219-323).

Aggregation stays on the host, as in the JAX package: the reference
averages diffs with a Python ``reduce(th.add)`` loop per parameter
(:275-290). Diffs arrive over sockets into host RAM, and each one folds
into a running per-parameter float64 sum at submit time
(:class:`_DiffAccumulator`, through ``native.accum_{f32,bf16}``), so cycle
completion is a single divide — O(1) in K, no K-diff restack, and no
host→device round-trip: the reduction's input is K× larger than its
output. Device-resident FedAvg — where diffs are *born* on the card — is
:mod:`pygrid_tpu_torch.parallel.fedavg`'s job.
"""

from __future__ import annotations

import contextlib
import datetime as dt
import logging
import threading
from typing import Any

import numpy as np

from pygrid_tpu_torch import telemetry
from pygrid_tpu_torch.federated import schemas as S
from pygrid_tpu_torch.federated import tasks
from pygrid_tpu_torch.federated.compression import decode_diff
from pygrid_tpu_torch.federated.managers import ModelManager, PlanManager, ProcessManager
from pygrid_tpu_torch.plans.state import host_model_params, serialize_model_params
from pygrid_tpu_torch.serde.wire import state_raw_tensors
from pygrid_tpu_torch.storage.warehouse import Database, Warehouse
from pygrid_tpu_torch.utils import exceptions as E

logger = logging.getLogger(__name__)

#: bound-variable budget per IN-list statement — safely under
#: SQLITE_MAX_VARIABLE_NUMBER on every SQLite build (999 historically),
#: so a legal many-thousand-member partial cannot blow a statement
_SQL_IN_CHUNK = 500


class _DiffAccumulator:
    """Running per-parameter (optionally weighted) sum of a cycle's diffs
    (float64 on host).

    Submit-time accumulation amortizes the reduction across reports; the
    float64 carry keeps the mean exact to f32 resolution regardless of K
    (a left-fold in f32 loses ~log2(K) bits; the reference's
    ``reduce(th.add)`` has the same flaw). Weights serve the async
    (FedBuff) path — staleness-discounted contributions — and default to
    1, which makes ``mean()`` the plain arithmetic mean."""

    def __init__(self) -> None:
        self.count = 0
        self.weight_sum = 0.0
        self.sums: list[np.ndarray] | None = None

    def add(self, diff: list[np.ndarray], weight: float = 1.0) -> None:
        if self.sums is None:
            self.sums = [
                np.asarray(t, dtype=np.float64) * weight for t in diff
            ]
        else:
            from pygrid_tpu_torch.native import accum_f32

            for s, t in zip(self.sums, diff):
                t = np.asarray(t)
                if t.dtype == np.float32:
                    # native one-pass fold (numpy cast-add fallback): no
                    # f64 temp the size of the diff (~19 ms/report saved
                    # for the MNIST MLP)
                    accum_f32(s, t, weight)
                elif weight == 1.0:
                    np.add(s, t, out=s)
                else:
                    s += np.multiply(t, weight, dtype=np.float64)
        self.count += 1
        self.weight_sum += weight

    def add_raw(self, raws: list, weight: float = 1.0) -> None:
        """Fold tensors still in wire form (``serde.RawTensor``) — the
        native one-pass accumulate; bf16 payloads fold without ever
        materializing as float32, and f64 payloads (hierarchical partial
        sums) view the wire buffer directly. Caller validated
        kinds/shapes."""
        from pygrid_tpu_torch.native import accum_bf16, accum_f32

        if self.sums is None:
            self.sums = [
                np.zeros(rt.shape, dtype=np.float64) for rt in raws
            ]
        for s, rt in zip(self.sums, raws):
            if rt.kind == "bf16":
                accum_bf16(s, rt.raw, weight)
            elif rt.kind == "<f8":
                flat = s.reshape(-1)
                src = np.frombuffer(rt.raw, dtype=np.float64)
                if weight == 1.0:
                    np.add(flat, src, out=flat)
                else:
                    flat += src * weight
            else:
                accum_f32(s, rt.raw, weight)
        self.count += 1
        self.weight_sum += weight

    def add_partial_raw(
        self,
        raws: list,
        count: int,
        weight_sum: float | None = None,
        scale: float = 1.0,
    ) -> None:
        """Count-weighted merge of a subtree's pre-folded partial SUM
        (federated/partials.py): sums add once, but the mean's divisor
        advances by the whole subtree — ``count`` leaf reports carrying
        ``weight_sum`` total weight (= count when unweighted). ``scale``
        serves the async (FedBuff) door: the subtree's staleness
        discount applied to both the payload and its weight, so the
        flush divides by what was actually folded."""
        if count < 1:
            raise E.PyGridError("cannot fold a zero-count partial report")
        if self.sums is None:
            self.sums = [
                np.zeros(rt.shape, dtype=np.float64) for rt in raws
            ]
        saved_count, saved_weight = self.count, self.weight_sum
        self.add_raw(raws, weight=scale)
        self.count = saved_count + int(count)
        self.weight_sum = saved_weight + scale * float(
            weight_sum if weight_sum is not None else count
        )

    def mean(self) -> list[np.ndarray]:
        if self.sums is None or self.weight_sum <= 0.0:
            # a cycle can flush with zero accepted reports (deadline
            # fires, every diff bounced validation); iterating
            # sums=None raised a raw TypeError / ZeroDivisionError —
            # surface the real condition typed instead
            raise E.PyGridError(
                "cannot average a cycle with zero accepted reports"
            )
        return [
            (s / self.weight_sum).astype(np.float32) for s in self.sums
        ]


def staleness_weight(staleness: int, power: float = 0.5) -> float:
    """FedBuff's staleness discount: ``(1 + s)^-p`` (Nguyen et al.,
    "Federated Learning with Buffered Asynchronous Aggregation", AISTATS
    '22 — their default p=1/2). s = checkpoints published since the
    worker downloaded its base model."""
    return float((1 + max(0, staleness)) ** (-power))


class CycleManager:
    def __init__(
        self,
        db: Database,
        process_manager: ProcessManager,
        model_manager: ModelManager,
        plan_manager: PlanManager,
    ) -> None:
        from pygrid_tpu_torch.federated.secagg_service import SecAggService

        self._cycles = Warehouse(S.Cycle, db)
        self._worker_cycles = Warehouse(S.WorkerCycle, db)
        if "flushed" in self._worker_cycles.migrated_columns:
            # pre-durability DB: whatever those rows contributed was
            # (or wasn't) applied by the old in-memory flush — either way
            # they must not re-enter a buffer and double-apply onto the
            # current checkpoint
            self._worker_cycles.modify(
                {"is_completed": True}, {"flushed": True}
            )
        self._opt_states = Warehouse(S.ServerOptState, db)
        self.process_manager = process_manager
        self.model_manager = model_manager
        self.plan_manager = plan_manager
        self.secagg = SecAggService(self)
        self._accum: dict[int, _DiffAccumulator] = {}
        self._accum_lock = threading.Lock()
        self._dp_cache: dict[int, dict | None] = {}
        self._async_cache: dict[int, dict | None] = {}
        self._robust_cache: dict[int, dict | None] = {}
        self._local_dp_cache: dict[int, dict | None] = {}
        # the FedBuff buffer is PROCESS-scoped, not cycle-scoped: an ingest
        # racing a flush then lands either before the pop (flushed now) or
        # after (first entry of the next buffer) — no orphaned cycle-keyed
        # accumulator a finishing cycle could silently discard
        self._async_accum: dict[int, _DiffAccumulator] = {}
        self._shape_cache: dict[int, list[tuple]] = {}
        self._deadline_timers: dict[int, threading.Timer] = {}
        # avg-plan presence is immutable after hosting — cached so the hot
        # report path doesn't re-query the plan table per diff
        self._fallback_mean_cache: dict[int, bool] = {}

    # --- lifecycle ----------------------------------------------------------

    def create(
        self, fl_process_id: int, version: str, cycle_time: int | None
    ) -> S.Cycle:
        """New cycle with the next sequence number; ``end`` set only when the
        process configures a cycle_length (reference :28-54)."""
        sequence = self._cycles.count(fl_process_id=fl_process_id) + 1
        now = dt.datetime.now(dt.timezone.utc).replace(tzinfo=None)
        end = now + dt.timedelta(seconds=cycle_time) if cycle_time else None
        cycle = self._cycles.register(
            fl_process_id=fl_process_id,
            sequence=sequence,
            version=version,
            start=now,
            end=end,
            is_completed=False,
        )
        telemetry.timeline.cycle_started(
            cycle.id, fl_process_id=fl_process_id, sequence=sequence
        )
        if cycle_time:
            self._schedule_deadline(cycle.id, cycle_time)
        return cycle

    def _schedule_deadline(self, cycle_id: int, delay_s: float) -> None:
        """Fire a readiness check at ``cycle.end`` so straggler-drop happens
        on time even if no further report ever arrives. The reference only
        re-checks readiness inside ``submit_worker_diff`` (cycle_manager.py
        :180-217) — a cycle whose remaining workers vanish after min_diffs
        hangs until some unrelated future event; here a timer closes it."""

        def _fire() -> None:
            self._deadline_timers.pop(cycle_id, None)
            tasks.run_task_once(
                f"complete_cycle_{cycle_id}", self.complete_cycle, cycle_id
            )

        timer = threading.Timer(max(delay_s, 0.0) + 0.05, _fire)
        timer.daemon = True
        self._deadline_timers[cycle_id] = timer
        timer.start()

    def recover_deadlines(self) -> None:
        """Re-arm deadline timers for open deadlined cycles (node restart —
        cycle state lives in SQL, timers don't; reference resumes from SQL
        the same way, SURVEY §5.4)."""
        now = dt.datetime.now(dt.timezone.utc).replace(tzinfo=None)
        for cycle in self._cycles.query(is_completed=False):
            if cycle.end is not None and cycle.id not in self._deadline_timers:
                self._schedule_deadline(
                    cycle.id, (cycle.end - now).total_seconds()
                )

    def recover_secagg(self) -> None:
        """Restart handshake for SecAgg cycles: their DH/Shamir state is
        in-memory by necessity (masked sums are meaningless without the
        live clients' keys), so an open cycle that had a round running
        when the node died cannot be resumed — close it explicitly and
        spawn the next cycle. Clients polling the dead round get a typed
        invalid-key error (their assignment's cycle completed) and re-run
        the key rounds on the fresh cycle, instead of hanging until their
        own timeouts."""
        for cycle in self._cycles.query(
            is_completed=False, secagg_started=True
        ):
            if cycle.id in self.secagg._cycles:
                continue  # live state — not a restart orphan
            logger.warning(
                "secagg cycle %s had a round in flight at shutdown — "
                "closing; clients re-key on the next cycle", cycle.id,
            )
            self.close_failed_cycle(cycle.id)

    def last(self, fl_process_id: int) -> S.Cycle:
        cycle = self._cycles.last(fl_process_id=fl_process_id, is_completed=False)
        if cycle is None:
            raise E.CycleNotFoundError()
        return cycle

    def last_participation(self, fl_process_id: int, worker_id: str) -> int:
        """Highest completed-cycle sequence this worker contributed to."""
        last = 0
        for wc in self._worker_cycles.query(
            worker_id=worker_id, is_completed=True, columns=("cycle_id",)
        ):
            cycle = self._cycles.first(id=wc.cycle_id)
            if cycle and cycle.fl_process_id == fl_process_id:
                last = max(last, cycle.sequence)
        return last

    # --- worker assignment --------------------------------------------------

    def assign(
        self,
        cycle: S.Cycle,
        worker_id: str,
        request_key: str,
        assigned_checkpoint: int = 0,
    ) -> S.WorkerCycle:
        tctx = telemetry.trace.current()
        telemetry.timeline.worker_assigned(
            cycle.id, worker_id,
            trace_id=tctx.trace_id if tctx is not None else None,
        )
        return self._worker_cycles.register(
            cycle_id=cycle.id,
            worker_id=worker_id,
            request_key=request_key,
            started_at=dt.datetime.now(dt.timezone.utc).replace(tzinfo=None),
            is_completed=False,
            assigned_checkpoint=assigned_checkpoint,
            fl_process_id=cycle.fl_process_id,
        )

    def has_open_assignment(self, fl_process_id: int, worker_id: str) -> bool:
        """An assignment the worker has not yet reported against, in ANY
        cycle of the process — the async re-admission gate. Stale keys stay
        reportable via re-homing, so an un-reported key from a flushed
        cycle must block a new one or a worker could hold several live
        keys and stack contributions in a single buffer."""
        for wc in self._worker_cycles.query(
            worker_id=worker_id, is_completed=False, columns=("cycle_id",)
        ):
            cycle = self._cycles.first(id=wc.cycle_id)
            if cycle is not None and cycle.fl_process_id == fl_process_id:
                return True
        return False

    def count_cycles(self, **filters: Any) -> int:
        return self._cycles.count(**filters)

    def count_worker_cycles(self, **filters: Any) -> int:
        return self._worker_cycles.count(**filters)

    def is_assigned(self, cycle_id: int, worker_id: str) -> bool:
        return self._worker_cycles.contains(cycle_id=cycle_id, worker_id=worker_id)

    def workers_in_cycle(self, cycle_id: int) -> int:
        return self._worker_cycles.count(cycle_id=cycle_id)

    def validate(self, worker_id: str, cycle_id: int, request_key: str) -> S.WorkerCycle:
        wc = self._worker_cycles.first(
            worker_id=worker_id,
            cycle_id=cycle_id,
            request_key=request_key,
            columns=(
                "id", "cycle_id", "worker_id", "request_key",
                "is_completed", "assigned_checkpoint",
            ),
        )
        if wc is None:
            raise E.InvalidRequestKeyError()
        return wc

    # --- diff submission + completion ---------------------------------------

    def resolve_worker_cycle(
        self, worker_id: str, request_key: str, include_completed: bool = False
    ) -> tuple[S.Cycle, S.WorkerCycle]:
        """The worker's open cycle for this request_key — the one
        resolution used by diff submission AND every secagg round.
        ``include_completed`` (the async path) also resolves keys whose
        cycle already flushed: a stale report re-homes to the current
        buffer instead of bouncing."""
        for candidate in self._worker_cycles.query(
            worker_id=worker_id,
            request_key=request_key,
            columns=(
                "id", "cycle_id", "worker_id", "request_key",
                "is_completed", "assigned_checkpoint", "started_at",
            ),
        ):
            cycle = self._cycles.first(
                id=candidate.cycle_id, is_completed=False
            )
            if cycle is not None:
                return cycle, candidate
            if include_completed:
                cycle = self._cycles.first(id=candidate.cycle_id)
                if cycle is not None:
                    return cycle, candidate
        raise E.InvalidRequestKeyError()

    def _note_report(
        self, cycle: S.Cycle, wc: S.WorkerCycle, diff: bytes,
        wire_codec: str | None,
    ) -> None:
        """Telemetry for one accepted report: assign→report latency into
        the histogram, bytes/codec/trace into the cycle's timeline. Never
        raises — observability must not fail a report that the protocol
        already accepted."""
        try:
            latency = None
            started_at = getattr(wc, "started_at", None)
            if started_at is not None:
                now = dt.datetime.now(dt.timezone.utc).replace(tzinfo=None)
                latency = max(0.0, (now - started_at).total_seconds())
                telemetry.observe("report_latency_seconds", latency)
            telemetry.incr(
                "report_bytes_total", len(diff), codec=wire_codec or "json"
            )
            tctx = telemetry.trace.current()
            telemetry.timeline.worker_report(
                cycle.id,
                wc.worker_id,
                latency_s=latency,
                n_bytes=len(diff),
                codec=wire_codec or "json",
                trace_id=tctx.trace_id if tctx is not None else None,
            )
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            logger.exception("report telemetry failed")

    def submit_worker_diff(
        self, worker_id: str, request_key: str, diff: bytes,
        wire_codec: str | None = None,
    ) -> None:
        """Store a worker's diff, then (dedup'd, possibly async) check cycle
        readiness (reference :151-178 + tasks/cycle.py)."""
        try:
            cycle, wc = self.resolve_worker_cycle(worker_id, request_key)
        except E.InvalidRequestKeyError:
            # a key whose cycle already flushed is still good on an async
            # (FedBuff) process — the report re-homes to the current buffer
            cycle, wc = self.resolve_worker_cycle(
                worker_id, request_key, include_completed=True
            )
            if self._async_config(cycle.fl_process_id) is None:
                raise E.InvalidRequestKeyError() from None
        if self._async_config(cycle.fl_process_id) is not None:
            self._submit_async(cycle, wc, diff)
            self._note_report(cycle, wc, diff, wire_codec)
            return
        if not diff:
            # an empty blob must not count toward readiness — completed rows
            # are what complete_cycle counts, so every one must carry a diff
            raise E.PyGridError("empty diff")
        if self.secagg.config_for(cycle.fl_process_id) is not None:
            # masked uint32 envelope: decode + shape-check + mod-2^32
            # accumulate (raises before any state change on a bad report);
            # the blob row still marks readiness like any other report
            self.secagg.ingest_masked(
                cycle.id, worker_id, diff,
                self._model_shapes(cycle.fl_process_id),
            )
            self._worker_cycles.modify(
                {"id": wc.id},
                {
                    "is_completed": True,
                    "completed_at": dt.datetime.now(dt.timezone.utc).replace(
                        tzinfo=None
                    ),
                    "diff": diff,
                },
            )
            self._note_report(cycle, wc, diff, wire_codec)
            tasks.run_task_once(
                f"complete_cycle_{cycle.id}", self.complete_cycle, cycle.id
            )
            return
        # decode BEFORE storing: a malformed blob must bounce back to the
        # reporting worker as an error, never become a stored poison row
        # that counts toward readiness and re-raises on every completion
        # attempt (a wrong-shaped diff is just as poisonous — zip() in the
        # accumulator would silently truncate)
        pid = cycle.fl_process_id
        raws = None
        if (
            self._uses_fallback_mean(pid)
            and self._robust_config(pid) is None
            and self._dp_config(pid) is None
        ):
            # fast ingest: plain dense State + plain mean → validate from
            # the wire headers and fold the raw buffers natively; anything
            # else (sparse envelope, odd dtype, malformed bytes) falls
            # through to the full decode door, which owns error reporting
            raws = state_raw_tensors(diff)
            if raws is not None:
                if any(rt.kind not in ("<f4", "bf16") for rt in raws):
                    raws = None
                else:
                    expected = self._model_shapes(pid)
                    got = [rt.shape for rt in raws]
                    if got != expected:
                        raise E.PyGridError(
                            f"diff shapes {got} do not match model "
                            f"shapes {expected}"
                        )
        decoded = (
            self._decode_and_check(diff, pid) if raws is None else None
        )
        self._worker_cycles.modify(
            {"id": wc.id},
            {
                "is_completed": True,
                "completed_at": dt.datetime.now(dt.timezone.utc).replace(tzinfo=None),
                "diff": diff,
            },
        )
        self._note_report(cycle, wc, diff, wire_codec)
        if self._uses_fallback_mean(cycle.fl_process_id) and (
            self._robust_config(cycle.fl_process_id) is None
        ):
            # fold into the running sum now — aggregation work rides each
            # report instead of spiking at cycle completion (the blob is
            # still stored above: parity surface + restart recovery).
            # Robust (order-statistic) processes skip this: median/trimmed
            # mean need every diff separately at completion.
            # Decode happened outside the lock: only the cheap fold
            # serializes.
            if raws is not None:
                with self._accum_lock:
                    acc = self._accum.setdefault(cycle.id, _DiffAccumulator())
                    acc.add_raw(raws)
            else:
                dp = self._dp_config(cycle.fl_process_id)
                if dp:
                    # clip at ingest: the accumulator only ever holds
                    # bounded per-client contributions (DP-FedAvg,
                    # federated/privacy.py; DP + custom avg plan is
                    # rejected at host time, so the fallback path is the
                    # only aggregation door under DP)
                    from pygrid_tpu_torch.federated.privacy import clip_diff

                    decoded = clip_diff(decoded, float(dp["clip_norm"]))
                with self._accum_lock:
                    acc = self._accum.setdefault(cycle.id, _DiffAccumulator())
                    acc.add(decoded)
            fresh = self._cycles.first(id=cycle.id)
            if fresh is not None and fresh.is_completed:
                # lost the race with completion (it rebuilt from blobs);
                # drop the orphaned entry or it leaks per raced cycle
                with self._accum_lock:
                    self._accum.pop(cycle.id, None)
        tasks.run_task_once(f"complete_cycle_{cycle.id}", self.complete_cycle, cycle.id)

    # --- hierarchical (sub-aggregated) reports ------------------------------

    def _resolve_partial_entries(
        self, entries: list[tuple[str, str]]
    ) -> tuple[S.Cycle, list[S.WorkerCycle], bool]:
        """Resolve every (worker_id, request_key) of a partial against
        ONE process — the node validates each member, so a sub-aggregator
        adds no trust surface over direct reports. Returns ``(cycle,
        worker_cycles, any_rehomed)``; sync callers additionally require
        one OPEN cycle, async callers one process (stale keys re-home
        like direct FedBuff reports)."""
        cycle: S.Cycle | None = None
        rehomed = False
        wcs: list[S.WorkerCycle] = []
        seen: set[str] = set()
        by_worker: dict[str, S.WorkerCycle] = {}
        for worker_id, request_key in entries:
            if worker_id in seen:
                raise E.PyGridError(
                    f"partial report lists worker {worker_id} twice"
                )
            seen.add(worker_id)
            wc = by_worker.get(worker_id)
            if wc is None or wc.request_key != request_key:
                # cache miss (first entry, a different cycle's key, or a
                # wrong key) → the full per-entry resolution door, which
                # owns the typed error
                try:
                    c, wc = self.resolve_worker_cycle(
                        worker_id, request_key
                    )
                except E.InvalidRequestKeyError:
                    c, wc = self.resolve_worker_cycle(
                        worker_id, request_key, include_completed=True
                    )
                    rehomed = True
                if cycle is None:
                    cycle = c
                    # batch prefetch: chunked IN-list selects load every
                    # member's row — a fanout-member partial must not
                    # pay one query per worker, and fetching only ITS
                    # workers keeps the cost O(fanout), not O(cycle).
                    # Chunked because a partial may legally carry tens
                    # of thousands of entries and SQLite caps bound
                    # variables per statement (SQLITE_MAX_VARIABLE_
                    # NUMBER, 999 on older builds)
                    members = [w for w, _ in entries]
                    by_worker = {
                        row.worker_id: row
                        for i in range(0, len(members), _SQL_IN_CHUNK)
                        for row in self._worker_cycles.query(
                            cycle_id=cycle.id,
                            worker_id=members[i : i + _SQL_IN_CHUNK],
                            columns=(
                                "id", "cycle_id", "worker_id",
                                "request_key", "is_completed",
                                "assigned_checkpoint", "started_at",
                            ),
                        )
                    }
                elif c.fl_process_id != cycle.fl_process_id:
                    raise E.PyGridError(
                        "partial report spans multiple FL processes"
                    )
            if wc.is_completed:
                raise E.PyGridError(
                    f"worker {worker_id} already reported for this "
                    "assignment"
                )
            wcs.append(wc)
        return cycle, wcs, rehomed

    def submit_worker_partial(
        self,
        entries: list[tuple[str, str]],
        diff: bytes,
        count: int,
        weight_sum: float | None = None,
        masked: bool = False,
        wire_codec: str | None = None,
    ) -> None:
        """Ingest one sub-aggregator partial: a subtree's pre-folded SUM
        plus the (worker_id, request_key) list it covers. The fold is a
        count-weighted merge into the same streaming accumulator the
        flat path uses (``_DiffAccumulator.add_partial_raw``), straight
        from the zero-copy wire views — per-worker tensors are never
        materialized and the node's residency per frame is one partial,
        regardless of how many workers stand behind it."""
        from pygrid_tpu_torch.federated.partials import (
            MAX_PARTIAL_COUNT,
            encode_partial_envelope,
        )

        if not entries:
            raise E.PyGridError("partial report carries no worker entries")
        if isinstance(count, bool) or not isinstance(count, int):
            raise E.PyGridError("partial count must be an integer")
        if count < 1:
            raise E.PyGridError("cannot fold a zero-count partial report")
        if count > MAX_PARTIAL_COUNT:
            raise E.PyGridError(
                f"partial count {count} exceeds {MAX_PARTIAL_COUNT}"
            )
        if count != len(entries):
            raise E.PyGridError(
                f"partial claims count {count} but carries "
                f"{len(entries)} worker entries"
            )
        ws = float(weight_sum) if weight_sum is not None else float(count)
        if not np.isfinite(ws) or not 0.0 < ws <= float(count):
            # leaf weights are staleness discounts in (0, 1] — a weight
            # beyond count would inflate the subtree's share of the mean
            raise E.PyGridError(
                f"partial weight_sum {ws} out of range (0, {count}]"
            )
        if not diff:
            raise E.PyGridError("empty diff")
        cycle, wcs, rehomed = self._resolve_partial_entries(entries)
        pid = cycle.fl_process_id
        async_cfg = self._async_config(pid)
        if rehomed and async_cfg is None:
            raise E.InvalidRequestKeyError()
        # aggregation modes that need INDIVIDUAL diffs cannot accept a
        # pre-summed subtree — reject typed so the sub-aggregator's
        # workers fall back to direct reports
        if self._robust_config(pid) is not None:
            raise E.PyGridError(
                "robust_aggregation needs individual diffs — partial "
                "reports not accepted"
            )
        if self._dp_config(pid) is not None:
            raise E.PyGridError(
                "differential_privacy clips each client's diff at ingest "
                "— partial reports not accepted"
            )
        if not self._uses_fallback_mean(pid):
            raise E.PyGridError(
                "a hosted averaging plan needs individual diffs — "
                "partial reports not accepted"
            )
        secagg_cfg = self.secagg.config_for(pid)
        if (secagg_cfg is not None) != bool(masked):
            raise E.PyGridError(
                "masked partial for a non-secagg process"
                if masked
                else "secure_aggregation process needs masked partials"
            )
        import time as _time

        t0 = _time.perf_counter()
        if masked:
            # mod-2^32 partial of masked vectors: masks still cancel at
            # the unmask round because masking is additive — the service
            # validates every member against the mask set before any
            # state change
            self.secagg.ingest_masked_partial(
                cycle.id,
                [w for w, _ in entries],
                diff,
                self._model_shapes(pid),
            )
            self._mark_partial_rows(
                wcs, encode_partial_envelope(diff, count, ws, masked=True)
            )
            self._note_partial(cycle, wcs, diff, wire_codec, count, t0)
            tasks.run_task_once(
                f"complete_cycle_{cycle.id}", self.complete_cycle, cycle.id
            )
            return
        raws = state_raw_tensors(diff)
        if raws is None or any(
            rt.kind not in ("<f4", "<f8", "bf16") for rt in raws
        ):
            raise E.PyGridError("partial diff is not a dense State")
        expected = self._model_shapes(pid)
        got = [rt.shape for rt in raws]
        if got != expected:
            raise E.PyGridError(
                f"diff shapes {got} do not match model shapes {expected}"
            )
        if async_cfg is not None:
            self._submit_async_partial(
                pid, wcs, raws, diff, count, ws, async_cfg
            )
            self._note_partial(cycle, wcs, diff, wire_codec, count, t0)
            return
        self._mark_partial_rows(
            wcs, encode_partial_envelope(diff, count, ws)
        )
        self._note_partial(cycle, wcs, diff, wire_codec, count, t0)
        with self._accum_lock:
            acc = self._accum.setdefault(cycle.id, _DiffAccumulator())
            acc.add_partial_raw(raws, count, ws)
        fresh = self._cycles.first(id=cycle.id)
        if fresh is not None and fresh.is_completed:
            # lost the race with completion (it rebuilt from blobs) —
            # same orphan-drop as the flat path
            with self._accum_lock:
                self._accum.pop(cycle.id, None)
        tasks.run_task_once(
            f"complete_cycle_{cycle.id}", self.complete_cycle, cycle.id
        )

    def _submit_async_partial(
        self,
        pid: int,
        wcs: list[S.WorkerCycle],
        raws: list,
        diff: bytes,
        count: int,
        ws: float,
        cfg: dict,
    ) -> None:
        """FedBuff door for a partial: the subtree folds in under its
        MEAN staleness discount (a pre-summed partial cannot re-weight
        members individually; sub-aggregator flush windows are short, so
        subtree members share a checkpoint in the common case — exact
        then, documented approximation otherwise, docs/AGGREGATION.md)."""
        from pygrid_tpu_torch.federated.partials import encode_partial_envelope

        model = self.model_manager.get(fl_process_id=pid)
        latest = self.model_manager.latest_number(model.id)
        power = float(cfg.get("staleness_power", 0.5))
        scale = float(
            np.mean(
                [
                    staleness_weight(
                        latest - (wc.assigned_checkpoint or latest), power
                    )
                    for wc in wcs
                ]
            )
        )
        open_cycle = self.last(pid)
        # encode OUTSIDE the fold lock: the envelope is a pure function
        # of the arguments, but msgpacking a model-scale diff takes
        # milliseconds — holding _accum_lock through it stalls every
        # concurrent report's fold (gridlint GL205). The row write +
        # fold stay one atomic step against the flush, which reads
        # unflushed rows and pops the accumulator under this same lock.
        envelope = encode_partial_envelope(diff, count, ws)
        with self._accum_lock:
            self._mark_partial_rows(wcs, envelope)
            acc = self._async_accum.setdefault(pid, _DiffAccumulator())
            acc.add_partial_raw(raws, count, ws, scale=scale)
        tasks.run_task_once(
            f"complete_cycle_{open_cycle.id}", self.complete_cycle,
            open_cycle.id,
        )

    def _mark_partial_rows(
        self, wcs: list[S.WorkerCycle], envelope: bytes
    ) -> None:
        """Durability for a subtree: the partial envelope lands on the
        FIRST member's row (the restart rebuild re-folds it with its
        original count/weight); the other members complete with an empty
        diff so readiness counts every worker exactly once without
        storing the payload fanout× times — node storage per subtree is
        one envelope, not one blob per worker.

        Members first, envelope LAST: the statements aren't one
        transaction, so a crash mid-way must fail SAFE — empty member
        rows without an envelope drop the subtree from a restart
        rebuild (first member's slot stays open, deadline recovers),
        whereas an envelope committed before its members would DOUBLE-
        count the subtree once those members re-reported directly."""
        now = dt.datetime.now(dt.timezone.utc).replace(tzinfo=None)
        if len(wcs) > 1:
            # batched UPDATEs (chunked IN-list — SQLite caps bound
            # variables per statement) — a subtree completes in a few
            # statements, not fanout+1
            member_ids = [wc.id for wc in wcs[1:]]
            for i in range(0, len(member_ids), _SQL_IN_CHUNK):
                self._worker_cycles.modify(
                    {"id": member_ids[i : i + _SQL_IN_CHUNK]},
                    {"is_completed": True, "completed_at": now,
                     "diff": b""},
                )
        self._worker_cycles.modify(
            {"id": wcs[0].id},
            {"is_completed": True, "completed_at": now, "diff": envelope},
        )

    def _note_partial(
        self,
        cycle: S.Cycle,
        wcs: list[S.WorkerCycle],
        diff: bytes,
        wire_codec: str | None,
        count: int,
        t0: float,
    ) -> None:
        """Telemetry for one accepted partial — never raises."""
        import time as _time

        try:
            telemetry.observe(
                "aggregation_partial_fold_seconds",
                max(0.0, _time.perf_counter() - t0),
            )
            telemetry.incr("aggregation_partials_total", 1, outcome="ok")
            telemetry.incr("aggregation_leaf_reports_total", count)
            telemetry.incr(
                "report_bytes_total", len(diff), codec=wire_codec or "json"
            )
            tctx = telemetry.trace.current()
            telemetry.timeline.worker_report(
                cycle.id,
                f"subtree[{count}]:{wcs[0].worker_id}",
                n_bytes=len(diff),
                codec=wire_codec or "json",
                trace_id=tctx.trace_id if tctx is not None else None,
            )
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            logger.exception("partial report telemetry failed")

    #: self-reported metric bounds: values are observability telemetry,
    #: not trusted statistics — the caps bound any single worker's
    #: influence on the aggregate curve (they cannot make it trustworthy
    #: against coordinated liars; nothing can, metrics are self-reported)
    METRIC_VALUE_BOUND = 1e6
    METRIC_MAX_SAMPLES = 10**6

    def submit_worker_metrics(
        self, worker_id: str, request_key: str, metrics: dict
    ) -> None:
        """Attach client-reported training metrics ({loss, acc,
        n_samples}) to the worker's assignment row. Accepted even after
        the cycle flushed (metrics often trail the diff); validated and
        bounded. Refused for privacy-configured processes: a per-client
        loss is a membership-inference signal, and storing it in the
        clear would void exactly what DP noise / SecAgg masking paid
        for."""
        cycle, wc = self.resolve_worker_cycle(
            worker_id, request_key, include_completed=True
        )
        pid = cycle.fl_process_id
        if (
            self._dp_config(pid) is not None
            or self.secagg.config_for(pid) is not None
            or self._local_dp_config(pid) is not None
        ):
            raise E.PyGridError(
                "per-client metrics are not stored for processes with "
                "differential_privacy, local_dp, or secure_aggregation "
                "(individual training loss is a membership-inference "
                "signal that would void what those features pay for)"
            )
        clean: dict[str, float] = {}
        for key in ("loss", "acc"):
            if key in metrics:
                value = float(metrics[key])
                if not np.isfinite(value) or abs(value) > self.METRIC_VALUE_BOUND:
                    raise E.PyGridError(f"metric {key} out of bounds")
                clean[key] = value
        n = int(metrics.get("n_samples", 1))
        if not 1 <= n <= self.METRIC_MAX_SAMPLES:
            raise E.PyGridError("n_samples out of range")
        clean["n_samples"] = n
        if not set(clean) - {"n_samples"}:
            raise E.PyGridError("metrics must include loss and/or acc")
        from pygrid_tpu_torch.serde import serialize

        self._worker_cycles.modify({"id": wc.id}, {"metrics": serialize(clean)})

    def _aggregate_cycle_metrics(self, cycle_id: int) -> tuple[dict, int]:
        """Sample-weighted (metric → mean, n_reports) for one cycle — the
        single aggregation both the full curve and the dashboard's latest
        value go through, so they cannot drift."""
        from pygrid_tpu_torch.serde import deserialize

        totals: dict[str, float] = {}
        weights: dict[str, float] = {}
        n_reports = 0
        for wc in self._worker_cycles.query(
            cycle_id=cycle_id, columns=("metrics",)
        ):
            if not wc.metrics:
                continue
            m = deserialize(wc.metrics)
            n = float(m.get("n_samples", 1))
            n_reports += 1
            for key in ("loss", "acc"):
                if key in m:
                    totals[key] = totals.get(key, 0.0) + m[key] * n
                    weights[key] = weights.get(key, 0.0) + n
        return (
            {key: total / weights[key] for key, total in totals.items()},
            n_reports,
        )

    def latest_metrics(self, fl_process_id: int) -> dict | None:
        """The newest cycle entry that has any reported metrics, or None.
        Walks cycles newest-first and stops at the first hit, so the
        dashboard's poll stays O(recent) instead of re-aggregating the
        whole history every refresh."""
        cycles = sorted(
            self._cycles.query(fl_process_id=fl_process_id),
            key=lambda c: c.sequence,
            reverse=True,
        )
        for cycle in cycles:
            means, _ = self._aggregate_cycle_metrics(cycle.id)
            if means:
                return {"cycle": cycle.sequence, **means}
        return None

    def cycle_metrics(self, fl_process_id: int) -> list[dict]:
        """Per-cycle sample-weighted aggregation of reported metrics —
        the fleet's training curve without any raw data leaving workers."""
        out = []
        for cycle in self._cycles.query(fl_process_id=fl_process_id):
            means, n_reports = self._aggregate_cycle_metrics(cycle.id)
            out.append(
                {
                    "cycle": cycle.sequence,
                    "completed": bool(cycle.is_completed),
                    "reports": n_reports,
                    **means,
                }
            )
        return sorted(out, key=lambda e: e["cycle"])

    # --- telemetry surface --------------------------------------------------

    def stats(self) -> dict:
        """Flight-recorder stats provider (periodic engine snapshots):
        the live aggregation state — per-cycle accumulator fill and the
        FedBuff buffers — so a crash dump shows how far each fold got
        before the crash."""
        with self._accum_lock:
            cycles = {
                str(cid): {"count": acc.count, "weight_sum": acc.weight_sum}
                for cid, acc in self._accum.items()
            }
            buffers = {
                str(pid): {"count": acc.count, "weight_sum": acc.weight_sum}
                for pid, acc in self._async_accum.items()
            }
        return {
            "cycle_accumulators": cycles,
            "fedbuff_buffers": buffers,
            "armed_deadlines": len(self._deadline_timers),
        }

    def cycle_timeline(self, cycle_id: int) -> dict | None:
        """The round timeline `GET /telemetry/cycles/<id>` serves: the
        in-memory telemetry record (phases, bytes per codec, traces)
        merged with the durable worker rows (assign/report timestamps
        survive a node restart even though the wire detail doesn't).
        None for a cycle this node has never seen."""
        cycle = self._cycles.first(id=cycle_id)
        snap = telemetry.timeline.snapshot(cycle_id)
        if cycle is None and snap is None:
            return None
        if snap is None:
            snap = {
                "cycle_id": cycle_id, "phases": {}, "workers": {},
                "bytes": {}, "traces": [], "assigned": 0, "reported": 0,
                "stragglers": None, "outcome": None,
            }
        if cycle is not None:
            snap["fl_process_id"] = cycle.fl_process_id
            snap["sequence"] = cycle.sequence
            snap["completed"] = bool(cycle.is_completed)
            snap["started_at"] = (
                cycle.start.isoformat() if cycle.start else None
            )
            rows = self._worker_cycles.query(
                cycle_id=cycle_id,
                columns=("worker_id", "started_at", "completed_at"),
            )
            snap = telemetry.timeline.merge_db_workers(snap, rows)
            snap["assigned"] = max(snap.get("assigned") or 0, len(rows))
        return snap

    def recent_cycles(self, limit: int = 20) -> list[dict]:
        """Newest-first cycle summaries for `GET /telemetry/cycles` and
        the dashboard poll."""
        return telemetry.timeline.recent(limit)

    def _decode_and_check(self, diff: bytes, fl_process_id: int) -> list:
        """The one report-validation door (sync + async): non-empty,
        decodable, shapes match the hosted model — a bad blob bounces to
        the reporting worker before any state changes."""
        if not diff:
            raise E.PyGridError("empty diff")
        try:
            decoded = decode_diff(diff)
        except Exception as err:
            raise E.PyGridError(f"undecodable diff: {err}") from err
        expected = self._model_shapes(fl_process_id)
        got = [tuple(np.shape(t)) for t in decoded]
        if got != expected:
            raise E.PyGridError(
                f"diff shapes {got} do not match model shapes {expected}"
            )
        return decoded

    def _submit_async(self, origin_cycle: S.Cycle, wc: S.WorkerCycle, diff: bytes) -> None:
        """FedBuff ingest: decode, staleness-weight, fold into the
        process's buffer (regardless of which cycle the key was minted
        in)."""
        if wc.is_completed:
            raise E.PyGridError("already reported for this assignment")
        pid = origin_cycle.fl_process_id
        decoded = self._decode_and_check(diff, pid)
        cfg = self._async_config(pid)
        model = self.model_manager.get(fl_process_id=pid)
        latest_number = self.model_manager.latest_number(model.id)
        base = wc.assigned_checkpoint or latest_number
        weight = staleness_weight(
            latest_number - base, float(cfg.get("staleness_power", 0.5))
        )
        open_cycle = self.last(pid)
        # row write + fold are one atomic step against the flush (which
        # reads unflushed rows and pops the accumulator under this same
        # lock) — the SQL rows are the DURABLE buffer, the accumulator is
        # its pre-folded fast path; they must never disagree on membership
        with self._accum_lock:
            self._worker_cycles.modify(
                {"id": wc.id},
                {
                    "is_completed": True,
                    "completed_at": dt.datetime.now(dt.timezone.utc).replace(
                        tzinfo=None
                    ),
                    "diff": diff,
                },
            )
            acc = self._async_accum.setdefault(pid, _DiffAccumulator())
            acc.add(decoded, weight)
        tasks.run_task_once(
            f"complete_cycle_{open_cycle.id}", self.complete_cycle,
            open_cycle.id,
        )

    def _async_buffered(
        self, fl_process_id: int, columns: tuple = ("id",)
    ) -> list[S.WorkerCycle]:
        """The durable FedBuff buffer: completed-but-unflushed rows of the
        process (stale keys re-home, so the buffer is process-scoped —
        fl_process_id is denormalized onto the rows so this is one query,
        on the per-report path). Caller picks columns — counting must not
        load megabyte diff blobs."""
        return self._worker_cycles.query(
            fl_process_id=fl_process_id,
            is_completed=True,
            flushed=False,
            columns=columns,
        )

    def _async_buffered_count(self, fl_process_id: int) -> int:
        return self._worker_cycles.count(
            fl_process_id=fl_process_id, is_completed=True, flushed=False
        )

    def _rebuild_async_buffer(
        self, fl_process_id: int, rows: list[S.WorkerCycle]
    ) -> _DiffAccumulator:
        """Restart path: re-fold the durable buffer rows (decode + re-clip
        + staleness-weight) into a fresh accumulator. Weights recompute
        from each row's assigned_checkpoint against the current latest —
        the same formula ingest used."""
        from pygrid_tpu_torch.federated.partials import decode_partial_envelope

        cfg = self._async_config(fl_process_id) or {}
        model = self.model_manager.get(fl_process_id=fl_process_id)
        latest_number = self.model_manager.latest_number(model.id)
        acc = _DiffAccumulator()
        for ref in rows:
            row = self._worker_cycles.first(
                id=ref.id, columns=("id", "diff", "assigned_checkpoint")
            )
            if row is None or not row.diff:
                continue
            env = None
            try:
                env = decode_partial_envelope(row.diff)
            except E.PyGridError:
                logger.warning(
                    "async rebuild: dropping damaged partial envelope %s",
                    ref.id,
                )
                continue
            if env is not None:
                # subtree envelope: re-fold under the envelope row's own
                # staleness discount (the same subtree-mean approximation
                # the live async door applied)
                pcount, pws, _pm, pstate = env
                praws = state_raw_tensors(pstate)
                if praws is None:
                    logger.warning(
                        "async rebuild: dropping unreadable partial %s",
                        ref.id,
                    )
                    continue
                base = row.assigned_checkpoint or latest_number
                acc.add_partial_raw(
                    praws,
                    pcount,
                    pws,
                    scale=staleness_weight(
                        latest_number - base,
                        float(cfg.get("staleness_power", 0.5)),
                    ),
                )
                continue
            try:
                decoded = self._decode_and_check(row.diff, fl_process_id)
            except E.PyGridError:
                logger.warning(
                    "async rebuild: dropping undecodable buffered diff %s",
                    ref.id,
                )
                continue
            base = row.assigned_checkpoint or latest_number
            acc.add(
                decoded,
                staleness_weight(
                    latest_number - base,
                    float(cfg.get("staleness_power", 0.5)),
                ),
            )
        return acc

    def _async_config(self, fl_process_id: int) -> dict | None:
        return self._cached_server_section(
            self._async_cache, fl_process_id, "async_aggregation"
        )

    def _robust_config(self, fl_process_id: int) -> dict | None:
        return self._cached_server_section(
            self._robust_cache, fl_process_id, "robust_aggregation"
        )

    def _local_dp_config(self, fl_process_id: int) -> dict | None:
        """client_config's local_dp section (cached; CLIENT config, so
        not servable by _cached_server_section)."""
        cached = self._local_dp_cache.get(fl_process_id, _UNSET)
        if cached is _UNSET:
            client_config = self.process_manager.get_configs(
                fl_process_id=fl_process_id, is_server_config=False
            )
            raw = client_config.get("local_dp")
            if raw is not None and not isinstance(raw, dict):
                raise E.PyGridError("local_dp must be a dict")
            cached = raw or None
            self._local_dp_cache[fl_process_id] = cached
        return cached

    def _model_shapes(self, fl_process_id: int) -> list[tuple]:
        """Expected diff tensor shapes — the model's parameter shapes, fixed
        at hosting (cached; the report path must not re-read the megabyte
        checkpoint per diff)."""
        cached = self._shape_cache.get(fl_process_id)
        if cached is None:
            model = self.model_manager.get(fl_process_id=fl_process_id)
            ckpt = self.model_manager.load(model_id=model.id, alias="latest")
            cached = [
                tuple(np.shape(t))
                for t in host_model_params(ckpt.value)
            ]
            self._shape_cache[fl_process_id] = cached
        return cached

    def _cached_server_section(
        self, cache: dict, fl_process_id: int, key: str
    ) -> dict | None:
        """One cached accessor for the optional server_config sections the
        hot paths branch on (DP / async / robust) — immutable after
        hosting, so the report path never re-queries per diff. A non-dict
        value fails typed BEFORE any falsy coercion (a hand-edited DB row
        must not silently disable a privacy/robustness feature); {} means
        unset."""
        cached = cache.get(fl_process_id, _UNSET)
        if cached is _UNSET:
            server_config = self.process_manager.get_configs(
                fl_process_id=fl_process_id, is_server_config=True
            )
            raw = server_config.get(key)
            if raw is not None and not isinstance(raw, dict):
                raise E.PyGridError(f"{key} must be a dict")
            cached = raw or None
            cache[fl_process_id] = cached
        return cached

    def _dp_config(self, fl_process_id: int) -> dict | None:
        return self._cached_server_section(
            self._dp_cache, fl_process_id, "differential_privacy"
        )

    def _uses_fallback_mean(self, fl_process_id: int) -> bool:
        """True when no hosted averaging plan will run (the hardcoded-FedAvg
        fallback path, reference :275-290) — only then is submit-time
        accumulation valid, since an avg plan sees individual diffs."""
        cached = self._fallback_mean_cache.get(fl_process_id)
        if cached is None:
            avg_plan = self.plan_manager._plans.first(
                fl_process_id=fl_process_id, is_avg_plan=True
            )
            cached = avg_plan is None or not avg_plan.value_xla
            self._fallback_mean_cache[fl_process_id] = cached
        return cached

    def _received_diffs(self, cycle_id: int) -> list[bytes]:
        return [
            wc.diff
            for wc in self._worker_cycles.query(
                cycle_id=cycle_id, is_completed=True, columns=("diff",)
            )
            if wc.diff
        ]

    def _cycle_context(
        self, cycle_id: int
    ) -> tuple[S.Cycle, S.FLProcess, dict] | None:
        """(cycle, process, server_config) for an OPEN cycle — the shared
        preamble of every completion door (plain, secagg, failed)."""
        cycle = self._cycles.first(id=cycle_id)
        if cycle is None or cycle.is_completed:
            return None
        process = self.process_manager.first(id=cycle.fl_process_id)
        server_config = self.process_manager.get_configs(
            fl_process_id=process.id, is_server_config=True
        )
        return cycle, process, server_config

    def complete_cycle(self, cycle_id: int) -> None:
        """Readiness: enough diffs AND (no limits OR max hit OR time up)
        (reference :180-217)."""
        context = self._cycle_context(cycle_id)
        if context is None:
            return
        cycle, process, server_config = context
        async_cfg = self._async_config(process.id)
        if async_cfg is not None:
            # FedBuff readiness: the durable buffer (completed-but-
            # unflushed rows) is the count — restart-safe where the
            # in-memory accumulator is not, and it already holds re-homed
            # stale reports
            received = self._async_buffered_count(process.id)
            time_up = cycle.end is not None and dt.datetime.now(
                dt.timezone.utc
            ).replace(tzinfo=None) >= cycle.end
            if received >= int(async_cfg["buffer_size"]) or (
                time_up and received >= 1
            ):
                self._average_plan_diffs(process, cycle, server_config)
            else:
                logger.info(
                    "async cycle %s buffer %s/%s", cycle_id, received,
                    async_cfg["buffer_size"],
                )
            return
        # readiness needs only the COUNT — loading the diff blobs here would
        # read O(K) megabytes per report, O(K²) per cycle; the blobs are
        # fetched once, in _average_plan_diffs, when the cycle is ready
        received = self._worker_cycles.count(cycle_id=cycle_id, is_completed=True)
        min_diffs = server_config.get("min_diffs")
        max_diffs = server_config.get("max_diffs")
        has_limits = max_diffs is not None or cycle.end is not None
        hit_max = max_diffs is not None and received >= max_diffs
        time_up = cycle.end is not None and dt.datetime.now(
            dt.timezone.utc
        ).replace(tzinfo=None) >= cycle.end
        enough = min_diffs is None or received >= min_diffs
        ready = enough and ((not has_limits) or hit_max or time_up)
        if not ready:
            logger.info(
                "cycle %s not ready: %s diffs (min=%s max=%s)",
                cycle_id, received, min_diffs, max_diffs,
            )
            return
        self._average_plan_diffs(process, cycle, server_config)

    # --- the FedAvg core ----------------------------------------------------

    @contextlib.contextmanager
    def _timed_phase(self, cycle_id: int, name: str = "aggregate"):
        """``profiling.timed("cycle.aggregate")`` (the /status surface)
        plus the telemetry twins: the cycle timeline's phase entry and
        the ``cycle_phase_seconds`` histogram — recorded even when the
        block returns early or raises."""
        from pygrid_tpu_torch.utils.profiling import timed

        box = None
        try:
            with timed(f"cycle.{name}") as box:
                yield
        finally:
            seconds = (box or {}).get("seconds")
            if seconds is not None:
                telemetry.timeline.phase(cycle_id, name, seconds)
                telemetry.observe(
                    "cycle_phase_seconds", seconds, phase=name
                )

    def _average_plan_diffs(
        self, process: S.FLProcess, cycle: S.Cycle, server_config: dict
    ) -> None:
        """(reference :219-323) average diffs → new checkpoint → next cycle.
        Timed under ``cycle.aggregate`` (surfaced by /data-centric/status/)."""
        if self.secagg.config_for(process.id) is not None:
            # masked sums cannot be averaged yet — hand the cycle to the
            # SecAgg unmask round; it calls back finish_secagg_cycle /
            # close_failed_cycle when the masks are resolved
            self.secagg.begin_unmasking(cycle, server_config)
            return

        if self._async_config(process.id) is not None:
            # FedBuff flush: the weighted buffer IS the aggregate. The
            # durable buffer is the completed-but-unflushed rows; the
            # in-memory accumulator is its pre-folded twin. A restarted
            # node (accumulator gone) rebuilds from the rows — their
            # diff + assigned_checkpoint recover payload and staleness
            # (weights recompute against the CURRENT latest checkpoint,
            # which only discounts survivors of a restart further).
            with self._timed_phase(cycle.id):
                with self._accum_lock:
                    rows = self._async_buffered(process.id)
                    acc = self._async_accum.pop(process.id, None)
                    if acc is not None and acc.count != len(rows):
                        acc = None  # restart or drift: rows are the truth
                if not rows:
                    logger.info(
                        "async cycle %s closed with empty buffer", cycle.id
                    )
                    self._finish_cycle(process, cycle, server_config)
                    return
                if acc is None:
                    acc = self._rebuild_async_buffer(process.id, rows)
                # everything fallible (decode, model load, mean) runs
                # BEFORE the flushed marks: a crash or error up to here
                # leaves the buffer intact for the next attempt. The marks
                # land immediately before the checkpoint write — the
                # residual crash window is two adjacent statements, not
                # the whole decode of N blobs.
                model = self.model_manager.get(fl_process_id=process.id)
                ckpt = self.model_manager.load(
                    model_id=model.id, alias="latest"
                )
                params = host_model_params(ckpt.value)
                avg = acc.mean() if acc.count else None
                for r in rows:
                    self._worker_cycles.modify(
                        {"id": r.id}, {"flushed": True}
                    )
                if avg is None:
                    logger.info(
                        "async cycle %s: rebuilt buffer empty", cycle.id
                    )
                    self._finish_cycle(process, cycle, server_config)
                    return
                self._apply_avg_and_close(
                    process, cycle, server_config, model, params, avg
                )
            return

        with self._timed_phase(cycle.id):
            if not self._worker_cycles.contains(
                cycle_id=cycle.id, is_completed=True
            ):
                # a deadline can fire with zero diffs (no min_diffs set):
                # the model is unchanged — close the cycle without a
                # checkpoint and move on rather than averaging nothing
                logger.info("cycle %s closed with no diffs", cycle.id)
                self._finish_cycle(process, cycle, server_config)
                return
            model = self.model_manager.get(fl_process_id=process.id)
            ckpt = self.model_manager.load(model_id=model.id, alias="latest")
            params = host_model_params(ckpt.value)

            avg_plan_rec = self.plan_manager._plans.first(
                fl_process_id=process.id, is_avg_plan=True
            )
            dp = self._dp_config(process.id)

            def _decode(d: bytes) -> list:
                # stored blobs are the raw uploads; under DP every decoded
                # contribution re-clips (the accumulator path clipped at
                # ingest — both doors must bound identically)
                decoded = decode_diff(d)
                if dp:
                    from pygrid_tpu_torch.federated.privacy import clip_diff

                    decoded = clip_diff(decoded, float(dp["clip_norm"]))
                return decoded

            n_diffs = 0
            robust_cfg = self._robust_config(process.id)
            if robust_cfg is not None:
                # order statistics need every diff separately — aggregate
                # from the stored rows. _decode (not raw decode_diff) so
                # this door stays on the one validated decode path: today
                # dp is None here (robust+DP rejected at host time), but
                # if that rule ever relaxes the re-clip must not silently
                # vanish
                from pygrid_tpu_torch.federated.robust import robust_aggregate

                diff_params = [
                    _decode(d) for d in self._received_diffs(cycle.id)
                ]
                n_diffs = len(diff_params)
                avg_diff = robust_aggregate(diff_params, robust_cfg)
            elif avg_plan_rec is not None and avg_plan_rec.value_xla:
                diff_params = [
                    _decode(d) for d in self._received_diffs(cycle.id)
                ]
                n_diffs = len(diff_params)
                avg_diff = self._run_avg_plan(
                    avg_plan_rec, diff_params, server_config
                )
            else:
                # hardcoded FedAvg fallback (reference reduce(th.add)/th.div
                # :275-290): the running sum folded at submit time makes
                # this a divide. A node restarted mid-cycle has no
                # accumulator — rebuild it from the stored blobs.
                with self._accum_lock:
                    acc = self._accum.pop(cycle.id, None)
                # count by SQL, not by loading every stored blob — the
                # blobs only load on the restart-recovery rebuild below
                n_received = self._worker_cycles.count(
                    cycle_id=cycle.id, is_completed=True
                )
                if acc is None or acc.count != n_received:
                    from pygrid_tpu_torch.federated.partials import (
                        decode_partial_envelope,
                    )

                    acc = _DiffAccumulator()
                    expected = self._model_shapes(process.id)
                    for d in self._received_diffs(cycle.id):
                        env = decode_partial_envelope(d)
                        if env is not None:
                            # a stored subtree envelope re-folds with its
                            # original count/weight — the rebuilt mean is
                            # identical to the live fold's (DP processes
                            # never accept partials, so no re-clip door)
                            pcount, pws, _pmasked, pstate = env
                            praws = state_raw_tensors(pstate)
                            if praws is None or [
                                rt.shape for rt in praws
                            ] != expected:
                                raise E.PyGridError(
                                    "stored partial envelope does not "
                                    "match model shapes"
                                )
                            acc.add_partial_raw(praws, pcount, pws)
                            continue
                        # restart-recovery rebuild rides the same raw-view
                        # fold as live ingest: stored dense blobs
                        # accumulate straight from their wire buffers (no
                        # array materialization); DP re-clip and sparse
                        # envelopes take the full decode door
                        raws = None if dp else state_raw_tensors(d)
                        if (
                            raws is not None
                            and all(
                                rt.kind in ("<f4", "bf16") for rt in raws
                            )
                            and [rt.shape for rt in raws] == expected
                        ):
                            acc.add_raw(raws)
                        else:
                            acc.add(_decode(d))
                n_diffs = acc.count  # the mean's actual divisor — a late
                # racing report must scale the noise it is averaged under
                avg_diff = acc.mean()

            if dp:
                from pygrid_tpu_torch.federated.privacy import add_gaussian_noise

                avg_diff = add_gaussian_noise(
                    avg_diff,
                    float(dp["clip_norm"]),
                    float(dp.get("noise_multiplier", 0.0)),
                    n_diffs,
                )

            self._apply_avg_and_close(
                process, cycle, server_config, model, params, avg_diff
            )

    def _apply_avg_and_close(
        self, process, cycle, server_config: dict, model, params, avg_diff
    ) -> None:
        """Shared tail of both aggregation doors (plain + secagg): server
        update → checkpoint → opt state → close/spawn next cycle."""
        new_params, opt_state = self._server_update(
            model.id, params, avg_diff, server_config
        )
        self.model_manager.save(model.id, serialize_model_params(new_params))
        self._save_opt_state(model.id, opt_state)
        self._finish_cycle(process, cycle, server_config)

    def finish_secagg_cycle(self, cycle_id: int, avg_diff: list) -> None:
        """SecAgg callback: the unmask round resolved ``avg_diff`` (the
        dequantized survivor mean) — apply the server update and close the
        cycle exactly like the plain aggregation path."""
        context = self._cycle_context(cycle_id)
        if context is None:
            return
        cycle, process, server_config = context
        with self._timed_phase(cycle.id):
            model = self.model_manager.get(fl_process_id=process.id)
            ckpt = self.model_manager.load(model_id=model.id, alias="latest")
            params = host_model_params(ckpt.value)
            self._apply_avg_and_close(
                process, cycle, server_config, model, params, avg_diff
            )

    def close_failed_cycle(self, cycle_id: int) -> None:
        """SecAgg callback: the cycle cannot be unmasked (too few
        survivors/shares) — close it without a checkpoint and spawn the
        next one so the process keeps going (the secagg analog of a
        zero-diff deadline close)."""
        context = self._cycle_context(cycle_id)
        if context is None:
            return
        cycle, process, server_config = context
        logger.warning("cycle %s closed without aggregation", cycle_id)
        self._finish_cycle(process, cycle, server_config)

    def _server_update(
        self, model_id: int, params: list, avg_diff: list, server_config: dict
    ) -> tuple[list, dict | None]:
        """Apply the configured server optimizer (FedOpt — server_opt.py) to
        the averaged pseudo-gradient; plain FedAvg when unconfigured."""
        from pygrid_tpu_torch.federated.server_opt import apply_server_optimizer
        from pygrid_tpu_torch.serde import deserialize

        opt_config = server_config.get("server_optimizer")
        state = None
        if opt_config:
            rec = self._opt_states.first(model_id=model_id)
            if rec is not None and rec.state:
                state = deserialize(rec.state)
        return apply_server_optimizer(params, avg_diff, opt_config, state)

    def _save_opt_state(self, model_id: int, state: dict | None) -> None:
        if state is None:
            return
        from pygrid_tpu_torch.serde import serialize

        blob = serialize(state)
        if self._opt_states.contains(model_id=model_id):
            self._opt_states.modify({"model_id": model_id}, {"state": blob})
        else:
            self._opt_states.register(model_id=model_id, state=blob)

    def _finish_cycle(
        self, process: S.FLProcess, cycle: S.Cycle, server_config: dict
    ) -> None:
        """Mark complete, release timer/accumulator, spawn the next cycle
        until ``num_cycles`` (reference :309-323)."""
        self._cycles.modify({"id": cycle.id}, {"is_completed": True})
        timer = self._deadline_timers.pop(cycle.id, None)
        if timer is not None:
            timer.cancel()
        with self._accum_lock:
            self._accum.pop(cycle.id, None)
        assigned = self._worker_cycles.count(cycle_id=cycle.id)
        reported = self._worker_cycles.count(
            cycle_id=cycle.id, is_completed=True
        )
        outcome = "aggregated" if reported else "empty"
        telemetry.timeline.cycle_closed(
            cycle.id, assigned=assigned, reported=reported, outcome=outcome
        )
        telemetry.incr("cycles_completed_total", 1, outcome=outcome)
        telemetry.record(
            "cycle.closed",
            cycle_id=cycle.id,
            fl_process_id=process.id,
            sequence=cycle.sequence,
            assigned=assigned,
            reported=reported,
        )

        num_cycles = server_config.get("num_cycles")
        if num_cycles is not None and cycle.sequence >= num_cycles:
            logger.info(
                "FL process %s (%s) completed!", process.id, process.name
            )
            return
        self.create(
            process.id, cycle.version, server_config.get("cycle_length")
        )

    def _run_avg_plan(
        self, avg_plan_rec: S.PlanRecord, diff_params: list[list], server_config: dict
    ) -> list:
        """Run the hosted averaging plan — iteratively per diff when
        ``server_config["iterative_plan"]`` (reference :261-271).

        ``device="cpu"`` is the reference's own placement
        (``pygrid_tpu/federated/cycle_manager.py:1633-1647`` pins this plan
        to the host CPU backend), not a fallback: the plan's inputs are K
        diffs fresh off the sockets (host RAM) and its output is 1/K their
        size, so putting it on the card would move K× more bytes than the
        result is worth."""
        plan = self.plan_manager.deserialize_plan(avg_plan_rec.value_xla)
        return self._run_avg_plan_inner(plan, diff_params, server_config)

    def _run_avg_plan_inner(
        self, plan, diff_params: list[list], server_config: dict
    ) -> list:
        if server_config.get("iterative_plan"):
            # running-mean signature avg = plan(*avg, *diff, i) — index LAST,
            # matching the reference's avg_plan(diff_avg, diff, tensor([i+1]))
            # (cycle_manager.py:269)
            avg = [np.asarray(p) for p in diff_params[0]]
            for i, diff in enumerate(diff_params[1:], start=1):
                out = plan(
                    *[np.asarray(a) for a in avg],
                    *[np.asarray(d) for d in diff],
                    np.float32(i + 1),
                    device="cpu",
                )
                out = list(out) if isinstance(out, (list, tuple)) else [out]
                avg = [np.asarray(a) for a in out]
            return avg
        flat: list = []
        for diff in diff_params:
            flat.extend(np.asarray(t) for t in diff)
        out = plan(*flat, device="cpu")
        return list(out) if isinstance(out, (list, tuple)) else [out]


#: sentinel distinguishing "not cached" from a cached None (processes
#: without a differential_privacy config)
_UNSET = object()
