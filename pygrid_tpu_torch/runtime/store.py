"""Object store — the party's id→tensor/model/plan map.

Parity surface: syft ``ObjectStore`` / ``worker._objects`` as the reference
uses it (tag scan over ``local_worker._objects`` at reference
``routes/data_centric/routes.py:171-189``; Redis write-through monkeypatch at
``data_centric/persistence/object_storage.py:26-62``). Entries carry the
permission metadata the reference's error path depends on
(``GetNotPermittedError`` — ``events/data_centric/syft_events.py:34-44``).

The port's own copy of :mod:`pygrid_tpu.runtime.store`. The store does not
place values: a :class:`~pygrid_tpu_torch.runtime.worker.VirtualWorker`
puts tensors on its device before they reach it. The ``on_set``/``on_del``
hooks (:mod:`pygrid_tpu_torch.datacentric.object_storage`) mirror the
reference's Redis write-through with a pluggable backend.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

from pygrid_tpu_torch.plans.placeholder import fresh_id
from pygrid_tpu_torch.utils.exceptions import (
    GetNotPermittedError,
    ObjectNotFoundError,
    PyGridError,
)


@dataclass
class StoredObject:
    value: Any
    id: int
    tags: set[str] = field(default_factory=set)
    description: str = ""
    #: None -> public; otherwise only these user names may .get() the value
    allowed_users: set[str] | None = None
    #: syft parity: whether a remote .get() removes the object here
    garbage_collect_data: bool = True

    def check_access(self, user: str | None) -> None:
        if self.allowed_users is not None and user not in self.allowed_users:
            raise GetNotPermittedError()


class ObjectStore:
    """id → StoredObject with tag search and persistence hooks."""

    def __init__(self, owner_id: str) -> None:
        self.owner_id = owner_id
        self._objects: dict[int, StoredObject] = {}
        #: write-through hooks (set by the persistence layer):
        #: on_set(owner_id, StoredObject), on_del(owner_id, obj_id)
        self.on_set: Callable[[str, StoredObject], None] | None = None
        self.on_del: Callable[[str, int], None] | None = None

    def set_obj(
        self,
        value: Any,
        id: int | None = None,
        tags: Iterable[str] = (),
        description: str = "",
        allowed_users: Iterable[str] | None = None,
        garbage_collect_data: bool = True,
        overwrite: bool = False,
    ) -> StoredObject:
        if id is not None and int(id) in self._objects and not overwrite:
            # client-chosen ids (ObjectMessage.id, command return_id) must not
            # silently replace existing objects — poisoning vector
            raise PyGridError(f"object id {id} already in use")
        obj = StoredObject(
            value=value,
            id=int(id) if id is not None else fresh_id(),
            tags=set(tags),
            description=description,
            allowed_users=set(allowed_users) if allowed_users is not None else None,
            garbage_collect_data=garbage_collect_data,
        )
        self._objects[obj.id] = obj
        if self.on_set:
            self.on_set(self.owner_id, obj)
        return obj

    def get_obj(self, obj_id: int) -> StoredObject:
        obj = self._objects.get(int(obj_id))
        if obj is None:
            raise ObjectNotFoundError(f"object {obj_id} not found")
        return obj

    def rm_obj(self, obj_id: int) -> None:
        self._objects.pop(int(obj_id), None)
        if self.on_del:
            self.on_del(self.owner_id, int(obj_id))

    def __contains__(self, obj_id: int) -> bool:
        return int(obj_id) in self._objects

    def __len__(self) -> int:
        return len(self._objects)

    def ids(self) -> list[int]:
        return list(self._objects)

    def search(self, query: Iterable[str]) -> list[StoredObject]:
        """All objects whose tags contain every query term (syft
        ``worker.search`` — reference routes.py:253-273)."""
        terms = set(query)
        return [o for o in self._objects.values() if terms <= o.tags]

    def tags(self) -> set[str]:
        out: set[str] = set()
        for o in self._objects.values():
            out |= o.tags
        return out

    def clear(self) -> None:
        self._objects.clear()
