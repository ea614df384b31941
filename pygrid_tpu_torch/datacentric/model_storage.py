"""Hosted-model persistence: durable storage + in-memory cache + controller.

Parity surface: reference ``data_centric/persistence/model_storage.py:15-178``
(Redis hash per ``sha256(worker_id + model_id)`` holding the serialized model
and its flags), ``model_cache.py:13-97`` (process-local cache) and
``model_controller.py:15-147`` (per-worker facade used by the model events
and routes). Flags carried per model: ``allow_download``,
``allow_remote_inference``, ``mpc``.

The port's counterpart of :mod:`pygrid_tpu.datacentric.model_storage`: the
same hash layout and serde bytes, so a store written by either package is
read by the other. A hosted Plan is the port's
:class:`~pygrid_tpu_torch.plans.plan.Plan` (call it with ``device=``); a
model that holds tensors in registered objects decodes onto the storage's
``device``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any

import torch

from pygrid_tpu_torch.datacentric.kvstore import KVStore, MemoryKV
from pygrid_tpu_torch.serde import deserialize, serialize
from pygrid_tpu_torch.utils.exceptions import (
    ModelNotFoundError,
    PyGridError,
)

_MODELS_INDEX = "models:index"  # hash: storage key -> model_id


@dataclass
class HostedModel:
    model_id: str
    model: Any  # Plan or raw params pytree
    allow_download: bool = False
    allow_remote_inference: bool = False
    mpc: bool = False
    serialized: bytes | None = field(default=None, repr=False)
    #: per-process memo of the parsed generative bundle — (cfg, device
    #: params) — filled by ``ServingManager.engine_for`` on first use
    generation_cache: Any = field(default=None, repr=False, compare=False)

    def flags(self) -> dict[str, Any]:
        return {
            "model_id": self.model_id,
            "allow_download": self.allow_download,
            "allow_remote_inference": self.allow_remote_inference,
            "mpc": self.mpc,
        }


class ModelCache:
    """In-memory model cache (reference model_cache.py:13-97)."""

    def __init__(self) -> None:
        self._cache: dict[str, HostedModel] = {}

    def contains(self, model_id: str) -> bool:
        return model_id in self._cache

    def save(self, hosted: HostedModel) -> None:
        self._cache[hosted.model_id] = hosted

    def get(self, model_id: str) -> HostedModel | None:
        return self._cache.get(model_id)

    def remove(self, model_id: str) -> None:
        self._cache.pop(model_id, None)

    @property
    def models(self) -> list[str]:
        return list(self._cache)


class ModelStorage:
    """Durable per-worker model storage (reference model_storage.py:15-178):
    each model lives under a hash named by sha256(worker_id + model_id);
    an index hash maps those names back to model ids."""

    def __init__(
        self,
        worker_id: str,
        kv: KVStore | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.worker_id = worker_id
        self.kv = kv if kv is not None else MemoryKV()
        self.cache = ModelCache()
        self.device = device

    def _key(self, model_id: str) -> str:
        # length-prefixed to keep (worker, model) pairs collision-free
        composite = f"{len(self.worker_id)}:{self.worker_id}:{model_id}"
        return hashlib.sha256(composite.encode()).hexdigest()

    @property
    def models(self) -> list[str]:
        out = []
        for entry in self.kv.hgetall(_MODELS_INDEX).values():
            rec = deserialize(entry)
            if rec["worker_id"] == self.worker_id:
                out.append(rec["model_id"])
        return out

    def contains(self, model_id: str) -> bool:
        return self.cache.contains(model_id) or self.kv.hexists(
            self._key(model_id), "model"
        )

    def save_model(
        self,
        serialized_model: bytes,
        model_id: str,
        allow_download: bool = False,
        allow_remote_inference: bool = False,
        mpc: bool = False,
    ) -> HostedModel:
        if self.contains(model_id):
            raise PyGridError(f"Model ID {model_id} already exists.")
        name = self._key(model_id)
        self.kv.hset(name, "model", serialized_model)
        self.kv.hset(
            name,
            "flags",
            serialize(
                {
                    "allow_download": allow_download,
                    "allow_remote_inference": allow_remote_inference,
                    "mpc": mpc,
                }
            ),
        )
        self.kv.hset(
            _MODELS_INDEX,
            name,
            serialize({"worker_id": self.worker_id, "model_id": model_id}),
        )
        hosted = HostedModel(
            model_id=model_id,
            model=deserialize(serialized_model, device=self.device),
            allow_download=allow_download,
            allow_remote_inference=allow_remote_inference,
            mpc=mpc,
            serialized=serialized_model,
        )
        self.cache.save(hosted)
        return hosted

    def get(self, model_id: str) -> HostedModel:
        cached = self.cache.get(model_id)
        if cached is not None:
            return cached
        name = self._key(model_id)
        blob = self.kv.hget(name, "model")
        if blob is None:
            raise ModelNotFoundError()
        flags = deserialize(self.kv.hget(name, "flags") or serialize({}))
        hosted = HostedModel(
            model_id=model_id,
            model=deserialize(blob, device=self.device),
            allow_download=bool(flags.get("allow_download")),
            allow_remote_inference=bool(flags.get("allow_remote_inference")),
            mpc=bool(flags.get("mpc")),
            serialized=blob,
        )
        self.cache.save(hosted)
        return hosted

    def remove(self, model_id: str) -> bool:
        name = self._key(model_id)
        self.cache.remove(model_id)
        self.kv.delete(name)
        self.kv.hdel(_MODELS_INDEX, name)
        return True


class ModelController:
    """worker id → ModelStorage facade (reference model_controller.py:15-147);
    the surface consumed by DC model events and HTTP routes."""

    def __init__(
        self, kv: KVStore | None = None, device: str | torch.device = "cuda"
    ) -> None:
        self.kv = kv if kv is not None else MemoryKV()
        self.device = device
        self._storages: dict[str, ModelStorage] = {}

    def storage(self, worker_id: str) -> ModelStorage:
        if worker_id not in self._storages:
            self._storages[worker_id] = ModelStorage(worker_id, self.kv, self.device)
        return self._storages[worker_id]

    def save(
        self,
        worker_id: str,
        serialized_model: bytes,
        model_id: str,
        allow_download: bool = False,
        allow_remote_inference: bool = False,
        mpc: bool = False,
    ) -> dict:
        self.storage(worker_id).save_model(
            serialized_model,
            model_id,
            allow_download=allow_download,
            allow_remote_inference=allow_remote_inference,
            mpc=mpc,
        )
        return {"success": True, "message": "Model saved with id: " + model_id}

    def get(self, worker_id: str, model_id: str) -> HostedModel:
        return self.storage(worker_id).get(model_id)

    def delete(self, worker_id: str, model_id: str) -> dict:
        self.storage(worker_id).remove(model_id)
        return {"success": True, "message": "Model deleted with id: " + model_id}

    def models(self, worker_id: str) -> list[str]:
        return self.storage(worker_id).models
