"""PointerTensor — client-side handle to a remote stored object: the port's
own copy of :mod:`pygrid_tpu.runtime.pointers`.

Parity surface: syft pointer semantics the reference tests exercise —
``x.send(node)``, remote arithmetic on pointers, ``.get()``, ``.move()``,
tags/description, ``garbage_collect_data`` (reference
``tests/data_centric/test_basic_syft_operations.py:190-232`` and the intro
notebook cells 25-52).

Transport-agnostic: a pointer talks to any *location* exposing
``recv_obj_msg(msg, user=None)`` — a local :class:`VirtualWorker` directly, or
a client proxy that ships the same serde bytes to a remote node. A torch
tensor goes into a message as it is: in process it reaches the worker
without a trip through the host, and on the wire serde writes its host copy.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from pygrid_tpu_torch.plans.placeholder import fresh_id
from pygrid_tpu_torch.runtime import messages as M
from pygrid_tpu_torch.utils.exceptions import PyGridError


def _raise_if_error(resp: Any) -> Any:
    if isinstance(resp, M.ErrorResponse):
        from pygrid_tpu_torch.utils import exceptions as E

        err_cls = getattr(E, resp.error_type, PyGridError)
        err = err_cls(resp.message)
        if resp.data and hasattr(err, "kwargs_"):
            err.kwargs_ = dict(resp.data)
        raise err
    return resp


def _payload(x: Any) -> Any:
    """A value as a message carries it: a torch tensor or a serde-registered
    object as it is, anything else as a numpy array."""
    if isinstance(x, torch.Tensor) or hasattr(x, "_bufferize"):
        return x
    return np.asarray(x)


class PointerTensor:
    def __init__(
        self,
        location: Any,
        id_at_location: int,
        shape: tuple | None = None,
        tags: Iterable[str] = (),
        owner_user: str | None = None,
    ) -> None:
        self.location = location
        self.id_at_location = int(id_at_location)
        self.shape = tuple(shape) if shape is not None else None
        self.tags = set(tags)
        self.owner_user = owner_user

    # --- lifecycle ----------------------------------------------------------

    def get(self, delete: bool = True) -> Any:
        """Fetch the value (permission-checked remotely)."""
        resp = self.location.recv_obj_msg(
            M.ObjectRequestMessage(obj_id=self.id_at_location, delete=delete),
            user=self.owner_user,
        )
        return _raise_if_error(resp)

    def delete(self) -> None:
        self.location.recv_obj_msg(
            M.ForceObjectDeleteMessage(obj_id=self.id_at_location),
            user=self.owner_user,
        )

    def move(self, other_location: Any) -> "PointerTensor":
        """Worker→worker transfer without the value passing through the
        client (syft ``.move(bob)``). ``other_location`` is the destination
        worker/client proxy — the returned pointer talks to it directly."""
        target_id = getattr(other_location, "id", str(other_location))
        resp = self._command(
            "send_to", [M.ref(self.id_at_location)], {"worker": target_id}
        )
        return PointerTensor(
            location=other_location,
            id_at_location=resp.id_at_location,
            shape=resp.shape,
            owner_user=self.owner_user,
        )

    # --- remote execution ---------------------------------------------------

    def _command(self, op: str, args: list, kwargs: dict) -> M.PointerResponse:
        resp = self.location.recv_obj_msg(
            M.TensorCommandMessage(
                op=op, args=args, kwargs=kwargs, return_id=fresh_id()
            ),
            user=self.owner_user,
        )
        return _raise_if_error(resp)

    def _wrap(self, resp: M.PointerResponse) -> "PointerTensor":
        return PointerTensor(
            location=self.location,
            id_at_location=resp.id_at_location,
            shape=resp.shape,
            owner_user=self.owner_user,
        )

    def _binary(self, op: str, other: Any) -> "PointerTensor":
        if isinstance(other, PointerTensor):
            arg: Any = M.ref(other.id_at_location)
        else:
            arg = _payload(other)
        return self._wrap(self._command(op, [M.ref(self.id_at_location), arg], {}))

    def __add__(self, other):
        return self._binary("__add__", other)

    def __sub__(self, other):
        return self._binary("__sub__", other)

    def __mul__(self, other):
        return self._binary("__mul__", other)

    def __truediv__(self, other):
        return self._binary("__truediv__", other)

    def __matmul__(self, other):
        return self._binary("__matmul__", other)

    def mm(self, other):
        return self.__matmul__(other)

    def __neg__(self):
        return self._wrap(self._command("__neg__", [M.ref(self.id_at_location)], {}))

    def remote_op(self, op: str, *args, **kwargs) -> "PointerTensor":
        """Generic method-style remote op: ``ptr.remote_op("sum", axis=0)``."""
        wire_args: list[Any] = [M.ref(self.id_at_location)]
        for a in args:
            wire_args.append(
                M.ref(a.id_at_location) if isinstance(a, PointerTensor) else a
            )
        return self._wrap(self._command(op, wire_args, kwargs))

    def sum(self, **kw):
        return self.remote_op("sum", **kw)

    def mean(self, **kw):
        return self.remote_op("mean", **kw)

    def relu(self):
        return self.remote_op("relu")

    def t(self):
        return self.remote_op("t")

    def __repr__(self) -> str:
        loc = getattr(self.location, "id", self.location)
        return (
            f"PointerTensor(location={loc!r}, id={self.id_at_location}, "
            f"shape={self.shape}, tags={sorted(self.tags)})"
        )


def send(
    x: Any,
    location: Any,
    tags: Iterable[str] = (),
    description: str = "",
    allowed_users: Iterable[str] | None = None,
    user: str | None = None,
    garbage_collect_data: bool = True,
) -> PointerTensor:
    """``x.send(worker)`` — push a value (a torch tensor as it is, anything
    else as a numpy array), get a pointer back."""
    resp = location.recv_obj_msg(
        M.ObjectMessage(
            obj=_payload(x),
            id=fresh_id(),
            tags=list(tags),
            description=description,
            allowed_users=list(allowed_users) if allowed_users is not None else None,
            garbage_collect_data=garbage_collect_data,
        ),
        user=user,
    )
    resp = _raise_if_error(resp)
    return PointerTensor(
        location=location,
        id_at_location=resp.id_at_location,
        shape=resp.shape,
        tags=tags,
        owner_user=user,
    )
