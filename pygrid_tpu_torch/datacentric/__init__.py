"""Data-centric plane: durable tensor/model persistence and user sessions.

Parity surface: reference ``apps/node/src/app/main/data_centric/`` —
``persistence/{database,object_storage,model_storage,model_cache,
model_controller}.py`` and ``auth/{user_session,session_repository}.py``.
The reference persists through a Redis singleton; no Redis lives in this
image, so the same write-through/read-through contract is implemented over a
pluggable key-value store (in-memory or sqlite-file backed).

The port's counterpart of :mod:`pygrid_tpu.datacentric`: its tensors,
models and per-user workers live on a ``device`` (default ``"cuda"``).
"""

from pygrid_tpu_torch.datacentric.kvstore import KVStore, MemoryKV, SqliteKV
from pygrid_tpu_torch.datacentric.model_storage import (
    ModelCache,
    ModelController,
    ModelStorage,
)
from pygrid_tpu_torch.datacentric.object_storage import (
    recover_objects,
    set_persistent_mode,
)
from pygrid_tpu_torch.datacentric.sessions import SessionsRepository, UserSession

__all__ = [
    "KVStore",
    "MemoryKV",
    "SqliteKV",
    "ModelCache",
    "ModelController",
    "ModelStorage",
    "recover_objects",
    "set_persistent_mode",
    "SessionsRepository",
    "UserSession",
]
