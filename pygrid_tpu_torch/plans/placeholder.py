"""PlaceHolder — a stable-id slot wrapping one array: the port's own copy of
:mod:`pygrid_tpu.plans.placeholder`, under the same wire name.

Execution-plane parity: the syft ``PlaceHolder`` the reference builds States
from (``models/model_manager.py:80-92`` does
``State(PlaceHolder().instantiate(param))``). Here a PlaceHolder is a plain
container: an integer id stable across serde round-trips plus a host array or
a torch tensor on any device. It is deliberately *not* a tracer: placeholders
only carry checkpoint tensors and their identities.
"""

from __future__ import annotations

import secrets
from typing import Any

import numpy as np

from pygrid_tpu_torch.serde import register_serde


def fresh_id() -> int:
    """Random 63-bit id — collision-safe across processes in a grid (a
    per-process counter would collide the moment a node deserializes a
    client's placeholders next to its own)."""
    return secrets.randbits(63)


def _is_torch(x: Any) -> bool:
    return (type(x).__module__ or "").startswith("torch")


@register_serde(name="pygrid.PlaceHolder")
class PlaceHolder:
    __slots__ = ("id", "tensor", "tags", "description")

    def __init__(
        self,
        tensor: Any = None,
        id: int | None = None,
        tags: set[str] | None = None,
        description: str = "",
    ) -> None:
        self.id = int(id) if id is not None else fresh_id()
        self.tensor = tensor
        self.tags = set(tags or ())
        self.description = description

    def instantiate(self, tensor: Any) -> "PlaceHolder":
        self.tensor = tensor
        return self

    def _bufferize(self) -> dict:
        # serde-registered wrappers (AdditiveSharingTensor…) and torch
        # tensors travel as themselves (serde copies a tensor to the host);
        # anything else is host-coerced — np.asarray on a wrapper would
        # build an object ndarray
        tensor = self.tensor
        if tensor is not None and not hasattr(tensor, "_bufferize") and not _is_torch(tensor):
            tensor = np.asarray(tensor)
        return {
            "id": self.id,
            "tensor": tensor,
            "tags": sorted(self.tags),
            "description": self.description,
        }

    @classmethod
    def _unbufferize(cls, data: dict) -> "PlaceHolder":
        return cls(
            tensor=data["tensor"],
            id=data["id"],
            tags=set(data["tags"]),
            description=data["description"],
        )

    def __repr__(self) -> str:
        shape = getattr(self.tensor, "shape", None)
        return f"PlaceHolder(id={self.id}, shape={shape}, tags={sorted(self.tags)})"
