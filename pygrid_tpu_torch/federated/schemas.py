"""Model-centric FL database schemas.

Parity surface (names, fields, relationships): reference ORM models under
``apps/node/src/app/main/model_centric/`` — FLProcess
(``processes/fl_process.py:4-34``), Config (``processes/config.py:4-23``),
Cycle (``cycles/cycle.py:4-29``), WorkerCycle (``cycles/worker_cycle.py:8-31``),
Worker (``workers/worker.py:4-25``), Model/ModelCheckPoint
(``models/ai_model.py:8-57``), Plan (``syft_assets/plan.py:4-29``), Protocol
(``syft_assets/protocol.py:4-25``).

The port's copy of :mod:`pygrid_tpu.federated.schemas`, with the port's imports.
"""

from __future__ import annotations

import datetime as dt
from dataclasses import dataclass, field


@dataclass
class FLProcess:
    id: int | None = None
    name: str = ""
    version: str = ""


@dataclass
class Config:
    id: int | None = None
    config: dict = field(default_factory=dict)
    is_server_config: bool = False
    fl_process_id: int = 0


@dataclass
class Cycle:
    id: int | None = None
    fl_process_id: int = 0
    sequence: int = 0
    version: str = ""
    start: dt.datetime | None = None
    end: dt.datetime | None = None
    is_completed: bool = False
    #: True once a SecAgg round started on this cycle (first advertise).
    #: SecAgg key state is in-memory by necessity, so a restarted node
    #: closes such cycles explicitly (recover_secagg) — clients get a
    #: typed invalid-key error and re-key on the next cycle instead of
    #: polling a silently-dead round forever
    secagg_started: bool = False


@dataclass
class WorkerCycle:
    #: secondary indexes (created by the Warehouse): the report plane
    #: resolves rows by (worker_id, request_key) once per report, counts
    #: readiness by (cycle_id, is_completed) once per report, and scans
    #: the FedBuff buffer by process — full table scans were invisible
    #: at 64 workers and the wall at 10k
    SQL_INDEXES = (
        ("worker_id", "request_key"),
        ("cycle_id", "is_completed"),
        ("fl_process_id", "is_completed", "flushed"),
    )
    id: int | None = None
    cycle_id: int = 0
    worker_id: str = ""
    request_key: str = ""
    started_at: dt.datetime | None = None
    is_completed: bool = False
    completed_at: dt.datetime | None = None
    diff: bytes | None = None
    #: checkpoint number current when this worker was assigned — async
    #: (FedBuff) aggregation weights its eventual report by how many
    #: checkpoints landed in between (staleness); 0 for sync processes
    assigned_checkpoint: int = 0
    #: optional client-reported training metrics (serialized
    #: {loss, acc, n_samples}) — aggregated sample-weighted per cycle by
    #: /model-centric/cycle-metrics; never part of the aggregation math
    metrics: bytes | None = None
    #: async (FedBuff) only: True once this contribution was consumed by a
    #: buffer flush. Rows with is_completed and not flushed ARE the
    #: durable buffer — a restarted node rebuilds from them (diff +
    #: assigned_checkpoint carry the payload and staleness base)
    flushed: bool = False
    #: denormalized from the cycle at assignment: the per-report buffer
    #: lookup must be ONE indexedable query, not a query per cycle of the
    #: process (0 on pre-upgrade rows — which the migration also marks
    #: flushed, so they never enter a buffer)
    fl_process_id: int = 0


@dataclass
class Worker:
    """FL client registry entry. String primary key (uuid worker_id)."""

    id: str = ""
    ping: float | None = None
    avg_download: float | None = None
    avg_upload: float | None = None


@dataclass
class Model:
    id: int | None = None
    version: str = ""
    fl_process_id: int = 0


@dataclass
class ModelCheckPoint:
    id: int | None = None
    value: bytes = b""
    model_id: int = 0
    number: int = 0
    alias: str = ""


@dataclass
class PlanRecord:
    """Stored plan with its three download variants (reference Plan schema's
    value/value_ts/value_tfjs blobs → value/value_xla/value_code)."""

    id: int | None = None
    name: str = ""
    value: bytes = b""          # portable op-list variant, serialized
    value_xla: bytes = b""      # exported StableHLO variant (torchscript slot)
    value_code: bytes = b""     # readable program text (tfjs slot)
    is_avg_plan: bool = False
    fl_process_id: int = 0


@dataclass
class ProtocolRecord:
    id: int | None = None
    name: str = ""
    value: bytes = b""
    fl_process_id: int = 0


@dataclass
class ServerOptState:
    """FedOpt server-optimizer state (momentum / Adam moments) per model —
    a serde blob so a restarted node resumes with its estimates intact
    (no reference analog: the reference has no server optimizer)."""

    id: int | None = None
    model_id: int = 0
    state: bytes = b""
