"""Write-through/read-through tensor persistence for VirtualWorkers.

Parity surface: reference
``data_centric/persistence/object_storage.py:26-80`` — monkeypatches syft's
``ObjectStore.{set,get,rm,force_rm}_obj`` to mirror every stored tensor into
a Redis hash keyed by worker id, and ``recover_objects`` bulk-loads a
worker's state after a restart (lazily triggered on the first binary message,
reference ``events/data_centric/syft_events.py:29-30``).

The port's counterpart of :mod:`pygrid_tpu.datacentric.object_storage`
(the same hash layout and serde bytes). The
:class:`~pygrid_tpu_torch.runtime.store.ObjectStore` exposes ``on_set/on_del``
hooks, so no monkeypatching: persistence is attached, not patched in.
Stored values are serde blobs (tensors from any device, written as their
host copies; AdditiveSharingTensor shares, Plans — anything the wire format
carries). Recovered values go back onto the worker's device: registered
objects through ``deserialize(..., device=...)``, arrays through
:meth:`VirtualWorker.place <pygrid_tpu_torch.runtime.worker.VirtualWorker.place>`.
"""

from __future__ import annotations

from typing import Any

from pygrid_tpu_torch.datacentric.kvstore import KVStore
from pygrid_tpu_torch.runtime.store import StoredObject
from pygrid_tpu_torch.serde import deserialize, serialize


def _hash_name(worker_id: str) -> str:
    return f"objects:{worker_id}"


def _pack(obj: StoredObject) -> bytes:
    return serialize(
        {
            "id": obj.id,
            "value": obj.value,
            "tags": sorted(obj.tags),
            "description": obj.description,
            "allowed_users": (
                sorted(obj.allowed_users)
                if obj.allowed_users is not None
                else None
            ),
            "garbage_collect_data": obj.garbage_collect_data,
        }
    )


def _unpack(blob: bytes, device) -> dict[str, Any]:
    return deserialize(blob, device=device)


def set_persistent_mode(worker: Any, kv: KVStore) -> None:
    """Attach write-through persistence to ``worker``'s object store
    (reference ``set_persistent_mode``, object_storage.py:26-62)."""
    store = worker.store
    name = _hash_name(worker.id)

    def on_set(owner_id: str, obj: StoredObject) -> None:
        kv.hset(_hash_name(owner_id), str(obj.id), _pack(obj))

    def on_del(owner_id: str, obj_id: int) -> None:
        kv.hdel(_hash_name(owner_id), str(obj_id))

    store.on_set = on_set
    store.on_del = on_del
    # mirror anything already resident (e.g. objects stored pre-attach)
    for obj_id in store.ids():
        kv.hset(name, str(obj_id), _pack(store.get_obj(obj_id)))


def recover_objects(worker: Any, kv: KVStore) -> int:
    """Bulk-load a worker's persisted objects after restart (reference
    ``recover_objects``, object_storage.py:66-80), onto the worker's device.
    Returns count restored. Idempotent: objects already resident are left
    untouched."""
    store = worker.store
    restored = 0
    for key, blob in kv.hgetall(_hash_name(worker.id)).items():
        obj_id = int(key)
        if obj_id in store:
            continue
        data = _unpack(blob, worker.device)
        # bypass on_set while restoring (value came from the KV already)
        hook, store.on_set = store.on_set, None
        try:
            store.set_obj(
                value=worker.place(data["value"]),
                id=data["id"],
                tags=data["tags"],
                description=data["description"],
                allowed_users=data["allowed_users"],
                garbage_collect_data=data["garbage_collect_data"],
            )
        finally:
            store.on_set = hook
        restored += 1
    return restored
