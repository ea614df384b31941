"""Server-side SecAgg coordinator — the node's half of the Bonawitz
double-masking rounds (`federated/secagg.py` holds the math; this module
holds the per-cycle state machine the WS events drive).

The server is UNTRUSTED by design: it sees DH public keys, sealed share
bundles it cannot open, masked uint32 diffs, and — only after the cycle's
survivor set is fixed — Shamir shares that reconstruct exactly the mask
terms that failed to cancel (self-masks of survivors, pairwise masks
toward dropouts). At no point can it unmask a *reporting* client's
individual diff: that would need t shares of a survivor's ``sk``, which
the unmask round never requests (clients must enforce the same — a
well-formed client refuses to reveal ``sk`` shares for a worker the
server claims dropped but whose report the client saw acknowledged; the
node-side protocol simply never asks).

Phases per cycle::

    ADVERTISE -- roster_size pubkeys in --> SHARES
    SHARES    -- all roster bundles in (or grace timeout) --> MASKING
    MASKING   -- cycle readiness fires (min_diffs/deadline) --> UNMASKING
    UNMASKING -- >= t shares per needed secret --> DONE (checkpoint)
              -- unmask deadline, short of t --> FAILED (cycle closed)

No reference analog (the reference ships raw diffs,
fl_events.py:237-271). SecAgg state is in-memory per cycle: masked sums
are meaningless without the live clients' keys, so — unlike plain FL
cycles, which resume from SQL after a node restart — a secagg round
cannot survive its node. The restart is explicit, not silent: the first
advertise durably marks the cycle (``Cycle.secagg_started``) and a
restarted node closes such cycles (``CycleManager.recover_secagg``),
so clients get a typed invalid-key error and re-run the key rounds on
the freshly-spawned next cycle.

The port's copy of :mod:`pygrid_tpu.federated.secagg_service`, with the port's imports.
"""

from __future__ import annotations

import logging
import threading
from typing import TYPE_CHECKING, Any

import numpy as np

from pygrid_tpu_torch.federated import secagg
from pygrid_tpu_torch.utils import exceptions as E

if TYPE_CHECKING:  # pragma: no cover
    from pygrid_tpu_torch.federated.cycle_manager import CycleManager

logger = logging.getLogger(__name__)

ADVERTISE, SHARES, MASKING, UNMASKING, DONE, FAILED = (
    "advertise", "shares", "masking", "unmasking", "done", "failed",
)

#: grace (seconds) after roster close for stragglers' share bundles, and
#: for unmask responses after readiness — both overridable per process
DEFAULT_PHASE_TIMEOUT = 30.0

#: ceiling (seconds) on the masking phase — client training time. Without
#: it, a cycle whose workers vanish before min_diffs (and with no cycle
#: deadline) would pin model-sized uint32 sums in RAM forever. Overridable
#: per process via ``secure_aggregation["masking_timeout"]``.
DEFAULT_MASKING_TIMEOUT = 600.0


class _CycleState:
    def __init__(self, roster_size: int, threshold: int, clip_range: float):
        self.phase = ADVERTISE
        self.roster_size = roster_size
        self.threshold = threshold
        self.clip_range = clip_range
        self.pubs: dict[str, int] = {}
        self.bundles: dict[str, dict[str, str]] = {}  # from → {to: hex}
        self.mask_set: list[str] = []
        self.sums: list[np.ndarray] | None = None
        self.reported: set[str] = set()
        self.survivors: list[str] = []
        self.dropouts: list[str] = []
        self.b_shares: dict[str, dict[int, int]] = {}
        self.sk_shares: dict[str, dict[int, int]] = {}
        self.unmask_responded: set[str] = set()
        self.timer: threading.Timer | None = None


class SecAggService:
    """One per CycleManager; owns every active secagg cycle's state."""

    def __init__(self, cycle_manager: "CycleManager") -> None:
        self._cm = cycle_manager
        self._lock = threading.RLock()
        self._cycles: dict[int, _CycleState] = {}
        self._config_cache: dict[int, dict | None] = {}

    # ── config ───────────────────────────────────────────────────────────────

    def config_for(self, fl_process_id: int) -> dict | None:
        """The process's secure_aggregation server_config (cached —
        immutable after hosting; the report path must not re-query)."""
        if fl_process_id not in self._config_cache:
            server_config = self._cm.process_manager.get_configs(
                fl_process_id=fl_process_id, is_server_config=True
            )
            raw = server_config.get("secure_aggregation")
            if raw is not None and not isinstance(raw, dict):
                raise E.PyGridError("secure_aggregation must be a dict")
            self._config_cache[fl_process_id] = raw or None
        return self._config_cache[fl_process_id]

    @staticmethod
    def validate_host_config(server_config: dict) -> None:
        """Host-time validation (controller.create_process) — fail the
        hosting call, not every worker's cycle."""
        sa = server_config.get("secure_aggregation")
        if sa is None:
            return
        if not isinstance(sa, dict):
            raise E.PyGridError(
                "secure_aggregation must be a dict {clip_range, ...}"
            )
        clip = sa.get("clip_range")
        if not isinstance(clip, (int, float)) or clip <= 0:
            raise E.PyGridError(
                "secure_aggregation requires a positive clip_range"
            )
        if server_config.get("differential_privacy") is not None:
            raise E.PyGridError(
                "secure_aggregation cannot be combined with server-side "
                "differential_privacy (the server cannot clip what it "
                "cannot see; use client-side clipping)"
            )
        roster = sa.get("roster_size") or server_config.get(
            "max_workers"
        ) or server_config.get("min_workers")
        if not roster or roster < 2:
            raise E.PyGridError(
                "secure_aggregation needs roster_size (or max_workers/"
                "min_workers) >= 2"
            )
        t = sa.get("threshold")
        if t is not None and not (2 <= int(t) <= int(roster)):
            raise E.PyGridError("secure_aggregation threshold out of range")
        if t is not None and int(t) <= int(roster) // 2:
            # Bonawitz's guarantee against a malicious server needs an
            # honest-majority threshold: with t <= n/2 the server could
            # feed two disjoint t-quorums contradictory survivor/dropout
            # views and collect both b_i and sk_i shares for one client
            raise E.PyGridError(
                f"secure_aggregation threshold must exceed roster/2 "
                f"({t} <= {int(roster) // 2} of roster {roster})"
            )
        # readiness must never freeze a survivor set smaller than the
        # unmask threshold — such cycles would fail at unmask time, every
        # time, with only a server-side log to show for it
        eff_t = int(t) if t is not None else int(roster) // 2 + 1
        min_diffs = server_config.get("min_diffs")
        if min_diffs is None:
            raise E.PyGridError(
                "secure_aggregation requires min_diffs (without it a "
                "single report completes the cycle below the unmask "
                "threshold)"
            )
        if int(min_diffs) < eff_t:
            raise E.PyGridError(
                f"secure_aggregation needs min_diffs >= threshold "
                f"({min_diffs} < {eff_t})"
            )

    # ── cycle lookup / state ─────────────────────────────────────────────────

    def _find_cycle(self, worker_id: str, request_key: str):
        cycle, _ = self._cm.resolve_worker_cycle(worker_id, request_key)
        return cycle

    def _state(self, cycle, cfg: dict) -> _CycleState:
        """Under the lock: every caller resolves cycle state inside
        ``with self._lock`` (get-or-create must be atomic per cycle)."""
        st = self._cycles.get(cycle.id)
        if st is None:
            roster_size = int(
                cfg.get("roster_size")
                or self._server_config(cycle.fl_process_id).get("max_workers")
                or self._server_config(cycle.fl_process_id).get("min_workers")
            )
            threshold = int(cfg.get("threshold") or roster_size // 2 + 1)
            st = _CycleState(roster_size, threshold, float(cfg["clip_range"]))
            self._cycles[cycle.id] = st
        return st

    def _server_config(self, fl_process_id: int) -> dict:
        return self._cm.process_manager.get_configs(
            fl_process_id=fl_process_id, is_server_config=True
        )

    def _phase_timeout(self, cfg: dict) -> float:
        return float(cfg.get("phase_timeout", DEFAULT_PHASE_TIMEOUT))

    # ── round 0: advertise ───────────────────────────────────────────────────

    def advertise(
        self, worker_id: str, request_key: str, public_key_hex: str
    ) -> dict:
        cycle = self._find_cycle(worker_id, request_key)
        cfg = self.config_for(cycle.fl_process_id)
        if cfg is None:
            raise E.PyGridError("process does not use secure_aggregation")
        pub = secagg.hex_to_int(public_key_hex)
        if not 1 < pub < secagg.DH_PRIME - 1:
            raise E.PyGridError("invalid DH public key")
        roster_full = False
        with self._lock:
            created = cycle.id not in self._cycles
            st = self._state(cycle, cfg)
            if st.phase != ADVERTISE:
                raise E.PyGridError(f"secagg roster closed (phase={st.phase})")
            if created:
                # a partial roster must not stall forever: after the grace,
                # proceed with whoever advertised (if ≥ threshold) or fail
                self._arm_timer(
                    cycle.id, self._phase_timeout(cfg), self._close_roster
                )
                # durable marker: key state cannot survive a restart, so a
                # restarted node must know this cycle had a live round to
                # abort (recover_secagg) — clients then re-key on the next
                # cycle instead of polling a dead round
                self._cm._cycles.modify(
                    {"id": cycle.id}, {"secagg_started": True}
                )
            st.pubs[worker_id] = pub
            roster_full = len(st.pubs) >= st.roster_size
        if roster_full:
            self._close_roster(cycle.id)
        return {"status": "ok", "roster_pending": not roster_full}

    def _close_roster(self, cycle_id: int) -> None:
        failed = False
        with self._lock:
            st = self._cycles.get(cycle_id)
            if st is None or st.phase != ADVERTISE:
                return
            self._cancel_timer(st)
            if len(st.pubs) < max(2, st.threshold):
                logger.warning(
                    "secagg cycle %s failed: only %s advertisers "
                    "(threshold %s)", cycle_id, len(st.pubs), st.threshold,
                )
                failed = self._fail_locked(cycle_id)
            else:
                st.phase = SHARES
                cfg = self._cfg_of_cycle(cycle_id)
                self._arm_timer(
                    cycle_id, self._phase_timeout(cfg), self._close_shares
                )
        if failed:
            self._cm.close_failed_cycle(cycle_id)

    def _cfg_of_cycle(self, cycle_id: int) -> dict:
        cycle = self._cm._cycles.first(id=cycle_id)
        if cycle is None:
            return {}
        return self.config_for(cycle.fl_process_id) or {}

    def roster(self, worker_id: str, request_key: str) -> dict:
        cycle = self._find_cycle(worker_id, request_key)
        with self._lock:
            st = self._cycles.get(cycle.id)
            if st is None or st.phase == ADVERTISE:
                return {"status": "pending"}
            return {
                "status": "ready",
                "roster": {
                    wid: secagg.int_to_hex(pub)
                    for wid, pub in sorted(st.pubs.items())
                },
                "threshold": st.threshold,
                "clip_range": st.clip_range,
            }

    # ── round 1: share bundles ───────────────────────────────────────────────

    def submit_shares(
        self, worker_id: str, request_key: str, shares: dict[str, str]
    ) -> dict:
        cycle = self._find_cycle(worker_id, request_key)
        all_in = False
        with self._lock:
            st = self._cycles.get(cycle.id)
            if st is None or st.phase not in (SHARES, MASKING):
                raise E.PyGridError("secagg not in share phase")
            if worker_id not in st.pubs:
                raise E.PyGridError("worker not in secagg roster")
            if st.phase == MASKING:
                # mask_set already frozen (grace expired) — too late
                raise E.PyGridError("secagg share phase closed")
            expected = set(st.pubs) - {worker_id}
            if set(shares) != expected:
                # an incomplete bundle would doom the cycle at unmask time
                # (some peer's secret short of threshold) — reject NOW, at
                # the submitting client, not at the deadline
                raise E.PyGridError(
                    "share bundle must cover every roster peer exactly "
                    f"(missing {sorted(expected - set(shares))}, "
                    f"unknown {sorted(set(shares) - expected)})"
                )
            st.bundles[worker_id] = dict(shares)
            all_in = len(st.bundles) >= len(st.pubs)
        if all_in:
            self._close_shares(cycle.id)
        return {"status": "ok"}

    def _close_shares(self, cycle_id: int) -> None:
        failed = False
        with self._lock:
            st = self._cycles.get(cycle_id)
            if st is None or st.phase != SHARES:
                return
            self._cancel_timer(st)
            st.mask_set = sorted(st.bundles)
            if len(st.mask_set) < max(2, st.threshold):
                logger.warning(
                    "secagg cycle %s failed: only %s of %s workers "
                    "delivered shares (threshold %s)",
                    cycle_id, len(st.mask_set), len(st.pubs), st.threshold,
                )
                failed = self._fail_locked(cycle_id)
            else:
                st.phase = MASKING
                # bound the masking phase too: a cycle whose workers all
                # vanish before min_diffs (and with no cycle deadline) must
                # not pin model-sized uint32 sums forever
                cfg = self._cfg_of_cycle(cycle_id)
                self._arm_timer(
                    cycle_id, self._masking_timeout(cfg), self._masking_deadline
                )
                logger.info(
                    "secagg cycle %s masking: mask_set=%s",
                    cycle_id, st.mask_set,
                )
        if failed:
            self._cm.close_failed_cycle(cycle_id)

    def _masking_timeout(self, cfg: dict) -> float:
        return float(
            cfg.get("masking_timeout", DEFAULT_MASKING_TIMEOUT)
        )

    def _masking_deadline(self, cycle_id: int) -> None:
        # fetched before the lock: DB work never runs under the service lock
        context = self._cm._cycle_context(cycle_id)
        cycle, server_config = (
            (context[0], context[2]) if context is not None else (None, {})
        )
        min_diffs = server_config.get("min_diffs")
        proceed = False
        failed = False
        with self._lock:
            st = self._cycles.get(cycle_id)
            if st is None or st.phase != MASKING:
                return
            if (
                cycle is not None
                and min_diffs is not None
                and len(st.reported) >= int(min_diffs)
            ):
                # the deadline is readiness here, not failure: enough masked
                # reports arrived but the cycle's own readiness never fired
                # (cycle_length > masking_timeout, or max_diffs unreached) —
                # aggregating what we have beats discarding it
                proceed = True
            else:
                logger.warning(
                    "secagg cycle %s: masking deadline with %s/%s reports — "
                    "failing", cycle_id, len(st.reported), len(st.mask_set),
                )
                failed = self._fail_locked(cycle_id)
        if proceed:
            self.begin_unmasking(cycle, server_config)
        elif failed:
            self._cm.close_failed_cycle(cycle_id)

    # ── round 2: masked report ingest (called by CycleManager) ──────────────

    def ingest_masked(
        self, cycle_id: int, worker_id: str, blob: bytes, shapes: list[tuple]
    ) -> None:
        """Decode + accumulate a masked diff (mod 2^32). Raises before any
        state change on a malformed/out-of-phase report."""
        masked = secagg.decode_masked_diff(blob)
        got = [tuple(np.shape(t)) for t in masked]
        if got != shapes:
            raise E.PyGridError(
                f"masked diff shapes {got} do not match model shapes {shapes}"
            )
        with self._lock:
            st = self._cycles.get(cycle_id)
            if st is None or st.phase != MASKING:
                raise E.PyGridError(
                    "secagg cycle not accepting masked reports"
                )
            if worker_id not in st.mask_set:
                raise E.PyGridError("worker not in secagg mask set")
            if worker_id in st.reported:
                raise E.PyGridError("worker already reported")
            if st.sums is None:
                st.sums = [np.array(m, dtype=np.uint32, copy=True) for m in masked]
            else:
                for s, m in zip(st.sums, masked):
                    np.add(s, m, out=s)  # uint32 wraparound = mod 2^32
            st.reported.add(worker_id)

    def ingest_masked_partial(
        self,
        cycle_id: int,
        worker_ids: list[str],
        blob: bytes,
        shapes: list[tuple],
    ) -> None:
        """Accumulate a sub-aggregator's pre-summed masked partial — the
        mod-2^32 sum of its subtree's masked diffs. Additive masking
        makes this safe: Σ(dᵢ + maskᵢ) ≡ Σdᵢ + Σmaskᵢ (mod 2^32), so the
        pairwise masks cancel at the unmask round exactly as if each
        worker had reported directly; the server still never sees a
        plaintext diff (it sees strictly LESS than the flat path — only
        the subtree sum). Every member is validated against the mask set
        before any state change, so a partial cannot smuggle a
        non-roster worker into the survivor set."""
        masked = secagg.decode_masked_diff(blob)
        got = [tuple(np.shape(t)) for t in masked]
        if got != shapes:
            raise E.PyGridError(
                f"masked diff shapes {got} do not match model shapes {shapes}"
            )
        if not worker_ids:
            raise E.PyGridError("masked partial carries no workers")
        with self._lock:
            st = self._cycles.get(cycle_id)
            if st is None or st.phase != MASKING:
                raise E.PyGridError(
                    "secagg cycle not accepting masked reports"
                )
            for worker_id in worker_ids:
                if worker_id not in st.mask_set:
                    raise E.PyGridError(
                        f"worker {worker_id} not in secagg mask set"
                    )
                if worker_id in st.reported:
                    raise E.PyGridError(
                        f"worker {worker_id} already reported"
                    )
            if len(set(worker_ids)) != len(worker_ids):
                raise E.PyGridError("masked partial lists a worker twice")
            if st.sums is None:
                st.sums = [
                    np.array(m, dtype=np.uint32, copy=True) for m in masked
                ]
            else:
                for s, m in zip(st.sums, masked):
                    np.add(s, m, out=s)  # uint32 wraparound = mod 2^32
            st.reported.update(worker_ids)

    # ── readiness handoff (called by CycleManager._average_plan_diffs) ──────

    def begin_unmasking(self, cycle, server_config: dict) -> None:
        cfg = self.config_for(cycle.fl_process_id) or {}
        with self._lock:
            st = self._cycles.get(cycle.id)
            if st is not None and st.phase in (UNMASKING, DONE):
                # readiness can fire more than once (every report schedules
                # a completion check) — the unmask round is already running
                return
            if st is None or st.phase != MASKING:
                logger.warning(
                    "secagg cycle %s readiness in phase %s — closing",
                    cycle.id, None if st is None else st.phase,
                )
                failed = self._fail_locked(cycle.id)
            else:
                st.survivors = sorted(st.reported)
                st.dropouts = sorted(set(st.mask_set) - st.reported)
                if len(st.survivors) < st.threshold or not st.survivors:
                    logger.warning(
                        "secagg cycle %s: %s survivors < threshold %s — "
                        "failing", cycle.id, len(st.survivors), st.threshold,
                    )
                    failed = self._fail_locked(cycle.id)
                else:
                    failed = False
                    st.phase = UNMASKING
                    self._arm_timer(
                        cycle.id, self._phase_timeout(cfg),
                        self._unmask_deadline,
                    )
                    logger.info(
                        "secagg cycle %s unmasking: survivors=%s dropouts=%s",
                        cycle.id, st.survivors, st.dropouts,
                    )
        if failed:
            self._cm.close_failed_cycle(cycle.id)

    # ── round 3: unmask shares ───────────────────────────────────────────────

    def status(self, worker_id: str, request_key: str) -> dict:
        cycle = self._find_cycle(worker_id, request_key)
        with self._lock:
            st = self._cycles.get(cycle.id)
            if st is None:
                return {"phase": "none"}
            out: dict[str, Any] = {"phase": st.phase}
            if st.phase in (MASKING, UNMASKING):
                out["mask_set"] = st.mask_set
                # the worker's inbound share bundle (sealed to it, one entry
                # per roster peer that delivered shares)
                out["bundle"] = {
                    frm: bundle[worker_id]
                    for frm, bundle in st.bundles.items()
                    if worker_id in bundle and frm != worker_id
                }
            if st.phase == UNMASKING:
                out["survivors"] = st.survivors
                out["dropouts"] = st.dropouts
            return out

    def submit_unmask_shares(
        self,
        worker_id: str,
        request_key: str,
        b_shares: dict[str, tuple[int, str]],
        sk_shares: dict[str, tuple[int, str]],
    ) -> dict:
        cycle = self._find_cycle(worker_id, request_key)
        with self._lock:
            st = self._cycles.get(cycle.id)
            if st is None or st.phase in (DONE, FAILED):
                # the quorum resolved while this response was in flight —
                # a late reveal of sanctioned material is harmless
                return {"status": "ok"}
            if st.phase != UNMASKING:
                raise E.PyGridError("secagg cycle not unmasking")
            if worker_id not in st.survivors:
                raise E.PyGridError("only survivors may submit unmask shares")
            if worker_id in st.unmask_responded:
                return {"status": "ok"}
            # a share of sk for a SURVIVOR must never be accepted — t of
            # them would unmask that client's individual report
            leaked = set(sk_shares) & set(st.survivors)
            if leaked:
                raise E.PyGridError(
                    f"sk shares offered for surviving workers {sorted(leaked)}"
                )
            for target, (x, y_hex) in b_shares.items():
                if target in st.survivors:
                    st.b_shares.setdefault(target, {})[int(x)] = (
                        secagg.hex_to_int(y_hex)
                    )
            for target, (x, y_hex) in sk_shares.items():
                if target in st.dropouts:
                    st.sk_shares.setdefault(target, {})[int(x)] = (
                        secagg.hex_to_int(y_hex)
                    )
            st.unmask_responded.add(worker_id)
            finish_st = self._take_for_finish(cycle.id, st)
        if finish_st is not None:
            # reconstruction + checkpointing run OUTSIDE the service lock:
            # they expand full-model PRG streams and write the DB, and must
            # not stall every other cycle's advertise/status/shares calls
            self._finish(cycle, finish_st)
        return {"status": "ok"}

    def _take_for_finish(
        self, cycle_id: int, st: _CycleState
    ) -> _CycleState | None:
        """Under the lock: if the unmask quorum is met, claim the state
        (phase DONE, popped from the registry) so exactly one caller runs
        the reconstruction."""
        if not self._unmask_satisfied(st):
            return None
        st.phase = DONE
        self._cancel_timer(st)
        self._cycles.pop(cycle_id, None)
        return st

    def _unmask_satisfied(self, st: _CycleState) -> bool:
        need_b = all(
            len(st.b_shares.get(w, {})) >= st.threshold for w in st.survivors
        )
        need_sk = all(
            len(st.sk_shares.get(w, {})) >= st.threshold for w in st.dropouts
        )
        return need_b and need_sk

    def _unmask_deadline(self, cycle_id: int) -> None:
        finish_st = None
        failed = False
        with self._lock:
            st = self._cycles.get(cycle_id)
            if st is None or st.phase != UNMASKING:
                return
            cycle = self._cm._cycles.first(id=cycle_id)
            if cycle is None:
                return
            finish_st = self._take_for_finish(cycle_id, st)
            if finish_st is None:
                logger.warning(
                    "secagg cycle %s: unmask deadline with insufficient "
                    "shares — failing", cycle_id,
                )
                failed = self._fail_locked(cycle_id)
        if failed:
            self._cm.close_failed_cycle(cycle_id)
        elif finish_st is not None:
            self._finish(cycle, finish_st)

    # ── reconstruction + completion ─────────────────────────────────────────

    def _finish(self, cycle, st: _CycleState) -> None:
        """Reconstruct the unmasked mean and close the cycle. Runs WITHOUT
        the service lock — the caller claimed ``st`` via _take_for_finish
        (phase DONE, popped), so no other thread can touch it."""
        try:
            shapes = self._cm._model_shapes(cycle.fl_process_id)
            sums = st.sums
            # self-masks of survivors
            seeds = []
            for wid in st.survivors:
                secret = secagg.shamir_recover(
                    sorted(st.b_shares[wid].items())[: st.threshold]
                )
                # a forged/corrupt share reconstructs an arbitrary field
                # element (≥ 2^128 raises in to_bytes) — the except below
                # turns that into a failed cycle, not a wedged one
                seeds.append(secret.to_bytes(16, "big"))
            sums = secagg.remove_self_masks(sums, seeds, shapes)
            # dangling pairwise masks toward each dropout
            survivor_pubs = {w: st.pubs[w] for w in st.survivors}
            for wid in st.dropouts:
                sk = secagg.shamir_recover(
                    sorted(st.sk_shares[wid].items())[: st.threshold]
                )
                sums = secagg.remove_dangling_pairwise(
                    sums, wid, sk, survivor_pubs, shapes
                )
            avg = secagg.dequantize_sum(
                sums, st.clip_range, len(st.mask_set), len(st.survivors)
            )
        except Exception:  # noqa: BLE001 — worker-supplied share material
            logger.exception(
                "secagg cycle %s: unmask reconstruction failed — closing",
                cycle.id,
            )
            self._cm.close_failed_cycle(cycle.id)
            return
        logger.info(
            "secagg cycle %s unmasked: %s survivors averaged", cycle.id,
            len(st.survivors),
        )
        self._cm.finish_secagg_cycle(cycle.id, avg)

    def _fail_locked(self, cycle_id: int) -> bool:
        """Under the lock: mark FAILED, cancel the timer, drop the state.
        The caller MUST invoke ``self._cm.close_failed_cycle(cycle_id)``
        after releasing the lock — DB work never runs under the service
        lock (same discipline as _take_for_finish/_finish)."""
        st = self._cycles.pop(cycle_id, None)
        if st is not None:
            st.phase = FAILED
            self._cancel_timer(st)
        return True

    # ── timers ───────────────────────────────────────────────────────────────

    def _arm_timer(self, cycle_id: int, delay: float, fn) -> None:
        st = self._cycles[cycle_id]
        self._cancel_timer(st)
        timer = threading.Timer(delay, fn, args=(cycle_id,))
        timer.daemon = True
        st.timer = timer
        timer.start()

    def _cancel_timer(self, st: _CycleState) -> None:
        if st.timer is not None:
            st.timer.cancel()
            st.timer = None
