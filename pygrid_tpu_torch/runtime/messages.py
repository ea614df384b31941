"""Wire messages for the party runtime — the binary-frame protocol: the
port's own copy of :mod:`pygrid_tpu.runtime.messages`, under the same wire
names (``pygrid.msg.<Class>``), so a frame is the same bytes in both
packages. A torch tensor in a message (``ObjectMessage.obj``, a command's
literal argument) serializes as the host ndarray its copy gives.

Parity surface: the syft wire messages the reference forwards opaquely
(``forward_binary_message`` → ``worker._recv_msg(message)`` at reference
``events/data_centric/syft_events.py:18-45``). Here the message set is
first-party: each message is a serde-registered dataclass; a worker routes on
the class (``VirtualWorker._message_router``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from pygrid_tpu_torch.serde import register_serde


def _simple_serde(cls):
    """Dataclass -> dict serde using the declared fields."""
    names = [f for f in cls.__dataclass_fields__]

    def _bufferize(self):
        return {n: getattr(self, n) for n in names}

    def _unbufferize(klass, data):
        kwargs = {n: data[n] for n in names}
        for n, f in cls.__dataclass_fields__.items():
            if f.type in ("set[str]", "set") and kwargs[n] is not None:
                kwargs[n] = set(kwargs[n])
        return klass(**kwargs)

    cls._bufferize = _bufferize
    cls._unbufferize = classmethod(_unbufferize)
    return register_serde(cls, name=f"pygrid.msg.{cls.__name__}")


@_simple_serde
@dataclass
class ObjectMessage:
    """Push an object into the receiving worker's store (tensor ``.send()``)."""

    obj: Any
    id: int | None = None
    tags: list[str] = field(default_factory=list)
    description: str = ""
    allowed_users: list[str] | None = None
    garbage_collect_data: bool = True


@_simple_serde
@dataclass
class ObjectRequestMessage:
    """Fetch an object's value (pointer ``.get()``).

    Permission-checked against the *session* user supplied by the transport
    (``recv_obj_msg(msg, user=...)``) — identity never rides in the message,
    where a client could assert someone else's name.
    """

    obj_id: int
    delete: bool = True  # syft gc: a successful .get() removes the remote obj


@_simple_serde
@dataclass
class ForceObjectDeleteMessage:
    obj_id: int


@_simple_serde
@dataclass
class TensorCommandMessage:
    """Execute one op on stored objects: result ids are assigned remotely.

    ``op`` is a name in the command table (array functions, methods,
    operators);
    ``arg_ids``/``kwargs`` may reference stored objects by id via
    ``{"__ref__": id}`` or carry literal values.
    """

    op: str
    args: list[Any] = field(default_factory=list)
    kwargs: dict[str, Any] = field(default_factory=dict)
    return_id: int | None = None


@_simple_serde
@dataclass
class RunPlanMessage:
    """Execute a stored Plan on stored/literal args."""

    plan_id: int
    args: list[Any] = field(default_factory=list)
    return_id: int | None = None


@_simple_serde
@dataclass
class SearchMessage:
    query: list[str] = field(default_factory=list)


@_simple_serde
@dataclass
class IsNoneMessage:
    obj_id: int


@_simple_serde
@dataclass
class GetShapeMessage:
    obj_id: int


@_simple_serde
@dataclass
class CryptoRequestMessage:
    """Ask a crypto-provider worker to deal one primitive to the parties.

    ``op`` ∈ {"mul", "matmul", "trunc"}. For triples, ``shape_x``/``shape_y``
    are the operand shapes; for a truncation pair, ``shape_x`` is the value
    shape and ``shape_y`` carries ``[scale]``. The provider pushes each
    party's share arrays to the named party workers (its known-worker mesh)
    and answers with the stored object ids (:class:`CryptoDealResponse`).
    A strict-store provider with no stocked primitive raises
    ``EmptyCryptoPrimitiveStoreError`` — the refill round-trip the reference
    serializes over the wire (reference syft_events.py:34-45).
    """

    op: str
    shape_x: list[int]
    shape_y: list[int]
    party_ids: list[str] = field(default_factory=list)


@_simple_serde
@dataclass
class CryptoProvideMessage:
    """Refill the provider's primitive store (response to an empty-store
    error; mirrors syft's ``provide_primitives`` round)."""

    op: str
    shape_x: list[int]
    shape_y: list[int]
    n_parties: int
    n_instances: int = 1


@_simple_serde
@dataclass
class CryptoDealResponse:
    """Ids of the dealt share objects: ``ids[i]`` lists party i's object ids
    (one per component — [a,b,c] for a triple, [r,r'] for a trunc pair)."""

    party_ids: list[str]
    ids: list[list[int]] = field(default_factory=list)


@_simple_serde
@dataclass
class ErrorResponse:
    error_type: str
    message: str = ""
    #: extra payload (e.g. crypto-store refill kwargs)
    data: dict = field(default_factory=dict)


@_simple_serde
@dataclass
class PointerResponse:
    """Acknowledges a stored object: its remote id + metadata."""

    id_at_location: int
    location: str
    shape: list[int] | None = None
    tags: list[str] = field(default_factory=list)


def ref(obj_id: int) -> dict:
    """Build an argument reference to a stored object."""
    return {"__ref__": int(obj_id)}


def is_ref(v: Any) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"__ref__"}
