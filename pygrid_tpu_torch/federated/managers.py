"""Process/Plan/Protocol/Model/Worker managers for model-centric FL.

Parity surface: reference ``apps/node/src/app/main/model_centric/``:
ProcessManager (``processes/process_manager.py:21-137``), PlanManager
(``syft_assets/plan_manager.py:24-149``), ProtocolManager
(``syft_assets/protocol_manager.py``), ModelManager
(``models/model_manager.py:19-103``), WorkerManager
(``workers/worker_manager.py:15-76``).

The port's copy of :mod:`pygrid_tpu.federated.managers`, with the port's imports.
"""

from __future__ import annotations

import threading
from typing import Any

from pygrid_tpu_torch.federated import schemas as S
from pygrid_tpu_torch.plans.plan import Plan
from pygrid_tpu_torch.plans.translators import translate_plan
from pygrid_tpu_torch.serde import deserialize, serialize
from pygrid_tpu_torch.storage.warehouse import Database, Warehouse
from pygrid_tpu_torch.utils import exceptions as E


class PlanManager:
    def __init__(self, db: Database) -> None:
        self._plans = Warehouse(S.PlanRecord, db)

    def register(
        self, process: S.FLProcess, plans: dict[str, Plan | bytes], avg_plan: bool
    ) -> None:
        """Deserialize each uploaded plan and store its download variants
        (reference trims to list/ts/tfjs at host time, plan_manager.py:24-59;
        the avg plan is stored raw :57-59)."""
        for name, plan in plans.items():
            if isinstance(plan, (bytes, bytearray)):
                plan = deserialize(bytes(plan))
            if not isinstance(plan, Plan):
                raise E.PlanInvalidError(f"plan {name!r} is not a Plan")
            self._plans.register(
                name=name,
                value=serialize(translate_plan(plan, "list"))
                if plan.oplist is not None
                else b"",
                value_xla=serialize(plan),
                value_code=(plan.code or "").encode(),
                is_avg_plan=avg_plan,
                fl_process_id=process.id,
            )

    def get(self, **filters: Any) -> S.PlanRecord:
        plan = self._plans.first(**filters)
        if plan is None:
            raise E.PlanNotFoundError()
        return plan

    def get_plans(self, **filters: Any) -> dict[str, int]:
        return {p.name: p.id for p in self._plans.query(**filters)}

    def get_variant(self, plan_id: int, variant: str) -> bytes:
        """Serve one download variant (reference receive_operations_as ∈
        {list, torchscript, tfjs} — routes.py:228-233)."""
        plan = self.get(id=plan_id)
        variant = {"torchscript": "xla", "tfjs": "code", "list": "list"}.get(
            variant, variant
        )
        blob = {
            "list": plan.value,
            "xla": plan.value_xla,
            "code": plan.value_code,
        }.get(variant)
        if blob is None:
            raise E.PlanTranslationError(f"unknown plan variant {variant!r}")
        if not blob:
            raise E.PlanTranslationError(f"variant {variant!r} not stored")
        return blob

    def deserialize_plan(self, blob: bytes) -> Plan:
        plan = deserialize(blob)
        if not isinstance(plan, Plan):
            raise E.PlanInvalidError()
        return plan

    def delete(self, **filters: Any) -> None:
        self._plans.delete(**filters)


class ProtocolManager:
    """Protocols are opaque blobs; optional (aggregation ignores them —
    reference cycle_manager.py:214)."""

    def __init__(self, db: Database) -> None:
        self._protocols = Warehouse(S.ProtocolRecord, db)

    def register(self, process: S.FLProcess, protocols: dict[str, bytes]) -> None:
        for name, value in protocols.items():
            self._protocols.register(
                name=name, value=bytes(value), fl_process_id=process.id
            )

    def get(self, **filters: Any) -> S.ProtocolRecord:
        proto = self._protocols.first(**filters)
        if proto is None:
            raise E.ProtocolNotFoundError()
        return proto

    def get_protocols(self, **filters: Any) -> dict[str, int]:
        return {p.name: p.id for p in self._protocols.query(**filters)}

    def delete(self, **filters: Any) -> None:
        self._protocols.delete(**filters)


class ProcessManager:
    """FLProcess rows, configs, and the plan/protocol id maps are all
    immutable once hosted — the protocol hot paths (authenticate,
    cycle-request, report: several lookups per message) serve them from
    in-memory caches invalidated only by create/delete."""

    def __init__(
        self, db: Database, plan_manager: PlanManager, protocol_manager: ProtocolManager
    ) -> None:
        self._processes = Warehouse(S.FLProcess, db)
        self._configs = Warehouse(S.Config, db)
        self.plan_manager = plan_manager
        self.protocol_manager = protocol_manager
        self._row_cache: dict[tuple, S.FLProcess] = {}
        self._config_cache: dict[tuple[int, bool], dict] = {}
        self._assets_cache: dict[tuple, dict] = {}

    def _invalidate(self) -> None:
        self._row_cache.clear()
        self._config_cache.clear()
        self._assets_cache.clear()

    def count(self, **filters: Any) -> int:
        return self._processes.count(**filters)

    def create(
        self,
        name: str,
        version: str,
        client_plans: dict[str, Any],
        client_protocols: dict[str, bytes],
        server_averaging_plan: Any,
        client_config: dict,
        server_config: dict,
    ) -> S.FLProcess:
        if self._processes.contains(name=name, version=version):
            raise E.FLProcessConflict()
        process = self._processes.register(name=name, version=version)
        self.plan_manager.register(process, client_plans, avg_plan=False)
        if server_averaging_plan is not None:
            self.plan_manager.register(
                process, {"averaging_plan": server_averaging_plan}, avg_plan=True
            )
        if client_protocols:
            self.protocol_manager.register(process, client_protocols)
        self._configs.register(
            config=client_config, is_server_config=False, fl_process_id=process.id
        )
        self._configs.register(
            config=server_config, is_server_config=True, fl_process_id=process.id
        )
        return process

    def first(self, **filters: Any) -> S.FLProcess:
        key = tuple(sorted(filters.items()))
        process = self._row_cache.get(key)
        if process is None:
            process = self._processes.first(**filters)
            if process is None:
                raise E.FLProcessNotFoundError()
            self._row_cache[key] = process
        return process

    def get(self, **filters: Any) -> list[S.FLProcess]:
        return self._processes.query(**filters)

    def get_configs(self, fl_process_id: int, is_server_config: bool) -> dict:
        key = (int(fl_process_id), bool(is_server_config))
        config = self._config_cache.get(key)
        if config is None:
            cfg = self._configs.first(
                fl_process_id=fl_process_id, is_server_config=is_server_config
            )
            if cfg is None:
                raise E.ConfigsNotFoundError()
            config = self._config_cache[key] = cfg.config
        return config

    def get_plans(self, fl_process_id: int, is_avg_plan: bool = False) -> dict:
        key = ("plans", int(fl_process_id), bool(is_avg_plan))
        plans = self._assets_cache.get(key)
        if plans is None:
            plans = self._assets_cache[key] = self.plan_manager.get_plans(
                fl_process_id=fl_process_id, is_avg_plan=is_avg_plan
            )
        return plans

    def get_protocols(self, fl_process_id: int) -> dict:
        key = ("protocols", int(fl_process_id))
        protocols = self._assets_cache.get(key)
        if protocols is None:
            protocols = self._assets_cache[key] = (
                self.protocol_manager.get_protocols(
                    fl_process_id=fl_process_id
                )
            )
        return protocols

    def delete(self, **filters: Any) -> None:
        for process in self._processes.query(**filters):
            self.plan_manager.delete(fl_process_id=process.id)
            self.protocol_manager.delete(fl_process_id=process.id)
            self._configs.delete(fl_process_id=process.id)
        self._processes.delete(**filters)
        self._invalidate()


class ModelManager:
    def __init__(self, db: Database) -> None:
        self._models = Warehouse(S.Model, db)
        self._checkpoints = Warehouse(S.ModelCheckPoint, db)
        #: (model_id, checkpoint_id, precision, codec) -> wire blob. Keyed
        #: by CHECKPOINT id, so a publish structurally invalidates — the
        #: new round's downloads miss to the new key and can never serve
        #: the previous round's bytes. K workers per cycle hit the same
        #: key: the checkpoint serializes/re-encodes/compresses once per
        #: round, not K times, and the sqlite megabyte row read is skipped.
        #: Lock: downloads run on executor threads while aggregation saves
        #: from the task thread — unsynchronized eviction would race.
        self._blob_cache: dict[tuple[int, int, str, str], bytes] = {}
        self._blob_lock = threading.Lock()
        self._latest_ckpt: dict[int, int] = {}
        self._model_row_cache: dict[tuple, S.Model] = {}

    def create(self, model_params_blob: bytes, process: S.FLProcess) -> S.Model:
        model = self._models.register(
            version=process.version, fl_process_id=process.id
        )
        self.save(model.id, model_params_blob)
        return model

    def get(self, **filters: Any) -> S.Model:
        # model rows are immutable (id/version/process fixed at hosting);
        # the request paths look one up per download/report
        key = tuple(sorted(filters.items()))
        model = self._model_row_cache.get(key)
        if model is None:
            model = self._models.first(**filters)
            if model is None:
                raise E.ModelNotFoundError()
            self._model_row_cache[key] = model
        return model

    def save(self, model_id: int, blob: bytes) -> S.ModelCheckPoint:
        """New checkpoint; re-aliases "latest" (reference
        model_manager.py:30-50). Publishing moves ``_latest_ckpt`` — the
        blob cache is keyed by checkpoint id, so every previous round's
        entries go stale-by-key; they're dropped eagerly here rather than
        waiting out the LRU."""
        self._checkpoints.modify({"model_id": model_id, "alias": "latest"}, {"alias": ""})
        number = self._checkpoints.count(model_id=model_id) + 1
        ckpt = self._checkpoints.register(
            value=blob, model_id=model_id, number=number, alias="latest"
        )
        with self._blob_lock:
            self._latest_ckpt[model_id] = ckpt.id
            for key in [
                k for k in self._blob_cache
                if k[0] == model_id and k[1] != ckpt.id
            ]:
                self._blob_cache.pop(key, None)
        self._cache_put((model_id, ckpt.id, "f32", "raw"), blob)
        return ckpt

    def load(self, **filters: Any) -> S.ModelCheckPoint:
        ckpt = self._checkpoints.last(**filters)
        if ckpt is None and filters.get("alias") == "latest":
            # save() re-aliases in two statements (clear old, insert new);
            # a reader landing between them finds NO "latest" row. The
            # newest checkpoint IS the latest — fall back to it instead
            # of 404ing mid-aggregation
            fallback = dict(filters)
            fallback.pop("alias")
            ckpt = self._checkpoints.last(**fallback)
        if ckpt is None:
            raise E.CheckPointNotFound()
        return ckpt

    def latest_number(self, model_id: int) -> int:
        """The newest checkpoint's ``number`` WITHOUT loading its blob —
        ``save`` numbers checkpoints 1..count, so the count IS the latest
        number. The async (FedBuff) staleness paths call this per report /
        per cycle-request; a megabyte row read there would violate the
        hot-path rule (_model_shapes' docstring)."""
        return self._checkpoints.count(model_id=model_id)

    def load_encoded(
        self,
        model_id: int,
        precision: str | None = None,
        codec: str | None = None,
    ) -> bytes:
        """Latest checkpoint blob re-encoded for the wire: ``precision=
        "bf16"`` halves the bytes; ``codec`` ("zlib"/"zstd", when this
        build has it) serves a compressed blob for peers that negotiated
        it. Checkpoints are immutable per id, so every worker in a cycle
        downloads the same bytes — each (checkpoint, encoding) variant is
        read/computed ONCE per round, not once per worker: at K workers
        per cycle the sqlite megabyte read (and the re-encode/compress
        pass) would otherwise repeat K times."""
        # normalize: unknown values serve the stored f32/raw blob — an
        # attacker-varied query string must not mint unbounded cache keys
        precision = "bf16" if precision == "bf16" else "f32"
        from pygrid_tpu_torch.serde import available_codecs

        codec = codec if codec in available_codecs() else "raw"
        with self._blob_lock:
            latest = self._latest_ckpt.get(model_id)
            if latest is not None:
                key = (model_id, latest, precision, codec)
                blob = self._blob_cache.get(key)
                if blob is not None:
                    # refresh recency: eviction must hit cold keys first
                    self._blob_cache.pop(key)
                    self._blob_cache[key] = blob
                    return blob
        ckpt = self.load(model_id=model_id)
        with self._blob_lock:
            cur = self._latest_ckpt.get(model_id)
            if cur is None or ckpt.id > cur:
                # never roll the pointer back: a save() racing this load
                # may already have published a newer checkpoint, and the
                # cache must not re-serve the older round's bytes as
                # "latest" (checkpoint ids are monotonically increasing)
                self._latest_ckpt[model_id] = ckpt.id
        blob = ckpt.value
        if precision == "bf16":
            from pygrid_tpu_torch.plans.state import (
                serialize_model_params,
                host_model_params,
            )

            blob = serialize_model_params(
                host_model_params(blob), bf16=True
            )
        if codec != "raw":
            from pygrid_tpu_torch.serde.wire import encode_frame

            # the frame envelope (tag byte + codec stream) is exactly what
            # a v2 peer unwraps with decode_frame — HTTP and WS downloads
            # share the one compressed representation
            blob = encode_frame(blob, codec)
        self._cache_put((model_id, ckpt.id, precision, codec), blob)
        return blob

    #: at most this many cached wire blobs (precision × codec variants per
    #: actively-served model); beyond it the oldest entry evicts — a node
    #: that hosted many finished processes must not keep their blobs
    #: resident forever
    BLOB_CACHE_MAX = 16

    def _cache_put(self, key: tuple, blob: bytes) -> None:
        with self._blob_lock:
            self._blob_cache.pop(key, None)
            self._blob_cache[key] = blob  # dict order = recency (LRU)
            while len(self._blob_cache) > self.BLOB_CACHE_MAX:
                oldest = next(iter(self._blob_cache), None)
                if oldest is None:
                    break
                self._blob_cache.pop(oldest, None)


class WorkerManager:
    def __init__(self, db: Database) -> None:
        self._workers = Warehouse(S.Worker, db)

    def create(self, worker_id: str) -> S.Worker:
        return self._workers.register(id=worker_id)

    def count(self, **filters: Any) -> int:
        return self._workers.count(**filters)

    def get(self, **filters: Any) -> S.Worker:
        worker = self._workers.first(**filters)
        if worker is None:
            raise E.WorkerNotFoundError()
        return worker

    def update(self, worker: S.Worker) -> None:
        self._workers.modify(
            {"id": worker.id},
            {
                "ping": worker.ping,
                "avg_download": worker.avg_download,
                "avg_upload": worker.avg_upload,
            },
        )

    def is_eligible(self, worker: S.Worker, server_config: dict) -> bool:
        """Bandwidth gating (reference worker_manager.py:52-76)."""
        min_upload = server_config.get("minimum_upload_speed")
        min_download = server_config.get("minimum_download_speed")
        if min_upload is not None and (worker.avg_upload or 0) < min_upload:
            return False
        if min_download is not None and (worker.avg_download or 0) < min_download:
            return False
        return True
