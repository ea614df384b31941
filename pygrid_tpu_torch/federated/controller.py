"""FLController — process creation, worker→cycle assignment, diff intake.

Parity surface: reference
``model_centric/controller/fl_controller.py``: ``create_process`` (:23),
``assign`` with dedup + eligibility + sha256 request key and the
accept/reject response shapes (:82-172), ``submit_diff`` (:184).

The port's copy of :mod:`pygrid_tpu.federated.controller`, with the port's imports.
"""

from __future__ import annotations

import datetime as dt
import hashlib
import uuid
from typing import Any

from pygrid_tpu_torch.federated import schemas as S
from pygrid_tpu_torch.federated.cycle_manager import CycleManager
from pygrid_tpu_torch.federated.managers import (
    ModelManager,
    PlanManager,
    ProcessManager,
    ProtocolManager,
    WorkerManager,
)
from pygrid_tpu_torch.storage.warehouse import Database
from pygrid_tpu_torch.utils import exceptions as E
from pygrid_tpu_torch.utils.codes import CYCLE, MSG_FIELD


class FLController:
    def __init__(self, db: Database) -> None:
        self.plan_manager = PlanManager(db)
        self.protocol_manager = ProtocolManager(db)
        self.process_manager = ProcessManager(
            db, self.plan_manager, self.protocol_manager
        )
        self.model_manager = ModelManager(db)
        self.worker_manager = WorkerManager(db)
        self.cycle_manager = CycleManager(
            db, self.process_manager, self.model_manager, self.plan_manager
        )

    # --- hosting ------------------------------------------------------------

    def create_process(
        self,
        model_blob: bytes,
        client_plans: dict[str, Any],
        name: str,
        version: str,
        client_config: dict,
        server_config: dict,
        server_averaging_plan: Any = None,
        client_protocols: dict[str, bytes] | None = None,
    ) -> S.FLProcess:
        """(reference :23-67) process + assets + configs + model + 1st cycle."""
        dp = server_config.get("differential_privacy")
        if dp is not None:
            # fail at host time, not on every worker's report
            if not isinstance(dp, dict):
                raise E.PyGridError(
                    "differential_privacy must be a dict "
                    "{clip_norm, noise_multiplier}"
                )
            clip = dp.get("clip_norm")
            if not isinstance(clip, (int, float)) or clip <= 0:
                raise E.PyGridError(
                    "differential_privacy requires a positive clip_norm"
                )
            if float(dp.get("noise_multiplier", 0.0)) < 0:
                raise E.PyGridError("noise_multiplier must be >= 0")
            if server_averaging_plan is not None:
                # the σ = z·C/K calibration assumes the unweighted mean; an
                # arbitrary hosted plan has unknown sensitivity
                raise E.PyGridError(
                    "differential_privacy cannot be combined with a custom "
                    "averaging plan (noise is calibrated to the mean's "
                    "C/K sensitivity)"
                )
        local_dp = (client_config or {}).get("local_dp")
        if local_dp is not None:
            # client-side DP — validated here so a bad config fails the
            # hosting call, not every worker's report. Unlike server-side
            # DP it composes with secure_aggregation (each report is
            # private before masking), so no combination gate.
            if not isinstance(local_dp, dict):
                raise E.PyGridError(
                    "local_dp must be a dict {clip_norm, noise_multiplier}"
                )
            clip = local_dp.get("clip_norm")
            if not isinstance(clip, (int, float)) or clip <= 0:
                raise E.PyGridError("local_dp requires a positive clip_norm")
            if float(local_dp.get("noise_multiplier", 0.0)) < 0:
                raise E.PyGridError("local_dp noise_multiplier must be >= 0")

        async_cfg = server_config.get("async_aggregation")
        if async_cfg is not None:
            if not isinstance(async_cfg, dict):
                raise E.PyGridError(
                    "async_aggregation must be a dict {buffer_size, "
                    "staleness_power}"
                )
            buffer_size = async_cfg.get("buffer_size")
            if not isinstance(buffer_size, int) or buffer_size < 1:
                raise E.PyGridError(
                    "async_aggregation requires an integer buffer_size >= 1"
                )
            power = async_cfg.get("staleness_power", 0.5)
            if not isinstance(power, (int, float)) or power < 0:
                raise E.PyGridError("staleness_power must be >= 0")
            if server_averaging_plan is not None:
                raise E.PyGridError(
                    "async_aggregation pre-reduces reports into a weighted "
                    "buffer — a custom averaging plan never sees them"
                )
            if dp is not None:
                raise E.PyGridError(
                    "async_aggregation cannot be combined with "
                    "differential_privacy (noise calibration assumes the "
                    "unweighted mean; staleness weights change sensitivity)"
                )
            if server_config.get("secure_aggregation") is not None:
                raise E.PyGridError(
                    "async_aggregation cannot be combined with "
                    "secure_aggregation (per-report staleness weights need "
                    "individually visible reports)"
                )

        from pygrid_tpu_torch.federated import robust

        robust.validate_config(server_config)
        if server_config.get("robust_aggregation") is not None:
            if server_averaging_plan is not None:
                raise E.PyGridError(
                    "robust_aggregation replaces the averaging step — a "
                    "custom averaging plan cannot run alongside it"
                )
            if (client_config or {}).get("diff_compression"):
                raise E.PyGridError(
                    "robust_aggregation is incompatible with "
                    "diff_compression (top-k sparse diffs are mostly zeros "
                    "after densify, so coordinate order statistics collapse "
                    "toward zero)"
                )

        from pygrid_tpu_torch.federated.secagg_service import SecAggService

        SecAggService.validate_host_config(server_config)
        if server_config.get("secure_aggregation") is not None:
            if server_averaging_plan is not None:
                raise E.PyGridError(
                    "secure_aggregation cannot run a custom averaging plan "
                    "(the server only ever sees the masked sum, never "
                    "individual diffs)"
                )
            if (client_config or {}).get("diff_compression"):
                raise E.PyGridError(
                    "secure_aggregation is incompatible with diff_compression "
                    "(masks must cover every coordinate of a dense envelope)"
                )
        process = self.process_manager.create(
            name=name,
            version=version,
            client_plans=client_plans,
            client_protocols=client_protocols or {},
            server_averaging_plan=server_averaging_plan,
            client_config=client_config,
            server_config=server_config,
        )
        self.model_manager.create(model_blob, process)
        self.cycle_manager.create(
            process.id, version, server_config.get("cycle_length")
        )
        return process

    # --- assignment ---------------------------------------------------------

    @staticmethod
    def _generate_hash_key() -> str:
        return hashlib.sha256(uuid.uuid4().hex.encode()).hexdigest()

    def last_cycle(self, name: str, version: str) -> tuple[S.FLProcess, S.Cycle]:
        process = self.process_manager.first(name=name, version=version)
        return process, self.cycle_manager.last(process.id)

    def assign(self, name: str, version: str, worker: S.Worker) -> dict:
        """Accept/reject a cycle request (reference :82-172)."""
        process, cycle = self.last_cycle(name, version)
        server_config = self.process_manager.get_configs(
            fl_process_id=process.id, is_server_config=True
        )

        # shared gates with HTTP /req-join (selection.eligibility_reason)
        # so the WS and HTTP admission paths cannot drift
        from pygrid_tpu_torch.federated.selection import eligibility_reason

        async_cfg = server_config.get("async_aggregation")
        already_in_cycle = (
            # FedBuff: a worker that reported may rejoin at once — only an
            # outstanding (un-reported) assignment blocks re-admission
            self.cycle_manager.has_open_assignment(process.id, worker.id)
            if async_cfg
            else self.cycle_manager.is_assigned(cycle.id, worker.id)
        )
        reject_reason = eligibility_reason(
            server_config=server_config,
            cycle_sequence=cycle.sequence,
            already_in_cycle=already_in_cycle,
            last_participation=self.cycle_manager.last_participation(
                process.id, worker.id
            ),
            up_speed=worker.avg_upload or 0,
            down_speed=worker.avg_download or 0,
        )
        if reject_reason is not None:
            response: dict[str, Any] = {CYCLE.STATUS: CYCLE.REJECTED}
            if cycle.end is not None:
                remaining = (
                    cycle.end
                    - dt.datetime.now(dt.timezone.utc).replace(tzinfo=None)
                ).total_seconds()
                response[CYCLE.TIMEOUT] = max(0, int(remaining))
            return response

        request_key = self._generate_hash_key()
        model = self.model_manager.get(fl_process_id=process.id)
        assigned_checkpoint = 0
        if async_cfg:
            # staleness baseline: the checkpoint this worker trains from
            # (number only — no blob read on the request path)
            assigned_checkpoint = self.model_manager.latest_number(model.id)
        self.cycle_manager.assign(
            cycle, worker.id, request_key,
            assigned_checkpoint=assigned_checkpoint,
        )
        return {
            CYCLE.STATUS: CYCLE.ACCEPTED,
            CYCLE.KEY: request_key,
            CYCLE.VERSION: cycle.version,
            MSG_FIELD.MODEL_ID: model.id,
            CYCLE.PLANS: self.process_manager.get_plans(process.id),
            CYCLE.PROTOCOLS: self.process_manager.get_protocols(process.id),
            CYCLE.CLIENT_CONFIG: self.process_manager.get_configs(
                fl_process_id=process.id, is_server_config=False
            ),
            MSG_FIELD.MODEL: process.name,
        }

    # --- reporting ----------------------------------------------------------

    def submit_diff(
        self,
        worker_id: str,
        request_key: str,
        diff: bytes,
        wire_codec: str | None = None,
    ) -> None:
        if not request_key:
            raise E.MissingRequestKeyError()
        self.cycle_manager.submit_worker_diff(
            worker_id, request_key, diff, wire_codec=wire_codec
        )

    def submit_partial(
        self,
        entries: list[tuple[str, str]],
        diff: bytes,
        count: int,
        weight_sum: float | None = None,
        masked: bool = False,
        wire_codec: str | None = None,
    ) -> None:
        """One sub-aggregator partial: a subtree's pre-folded diff sum
        covering ``entries`` = [(worker_id, request_key), ...] — every
        key is validated exactly like a direct report."""
        for worker_id, request_key in entries:
            if not request_key:
                raise E.MissingRequestKeyError()
            if not worker_id:
                raise E.PyGridError("partial entry missing worker_id")
        self.cycle_manager.submit_worker_partial(
            entries,
            diff,
            count,
            weight_sum=weight_sum,
            masked=masked,
            wire_codec=wire_codec,
        )
