"""VirtualWorker — the in-process party runtime: the port's counterpart of
:mod:`pygrid_tpu.runtime.worker`.

Parity surface: syft ``VirtualWorker`` as the reference instantiates and
drives it: the Node's singleton store/executor (reference
``apps/node/src/app/main/__init__.py:10-12``), per-user workers
(``data_centric/auth/user_session.py:29-34``), the binary message entry point
``worker._recv_msg(message)`` (``events/data_centric/syft_events.py:32``) and
``local_worker.search`` / ``_objects`` scans
(``routes/data_centric/routes.py:176,263``).

A worker lives on a ``device`` (default ``"cuda"``): every tensor it stores
goes there at the dtype it arrived with, and its ops run there as torch
ops. Two op tables, chosen per command as the reference chooses:

- **the ring path** (:data:`_ARRAY_OPS_I64`), taken when every tensor
  argument of rank ≥ 1 is a 64-bit integer — SMPC shares travel as int64.
  torch's int64 ops wrap mod 2^64 as numpy's do; ``matmul`` keeps
  ``np.matmul``'s semantics and is one launch of the ring-matmul kernel on
  the card (:func:`pygrid_tpu_torch.smpc.ring.ring_matmul_np`);
- **the float path** (:data:`_ARRAY_OPS`), with ``jnp``'s semantics under
  its default 64-bit-off mode: 64-bit operands compute at 32 bits (float64
  as float32, a 0-d int64 as int32), every array operand of any rank takes
  part in type promotion, ``argmax`` is int32 and an integer ``sum`` stays
  32-bit.

Messages are serde dataclasses (:mod:`pygrid_tpu_torch.runtime.messages`) —
the same bytes arrive over a WebSocket binary frame or a direct in-process
call.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import numpy as np
import torch

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.plans.plan import Plan
from pygrid_tpu_torch.runtime import messages as M
from pygrid_tpu_torch.runtime.store import ObjectStore, StoredObject
from pygrid_tpu_torch.serde import deserialize, serialize
from pygrid_tpu_torch.smpc import ring as R
from pygrid_tpu_torch.smpc.additive import AdditiveSharingTensor
from pygrid_tpu_torch.utils import exceptions as E

# --- the float path: jnp's semantics with 64-bit types off -------------------

#: jnp.asarray's canonicalisation with 64-bit types off (the JAX default)
_CANONICAL = {
    torch.float64: torch.float32,
    torch.int64: torch.int32,
    torch.uint64: torch.uint32,
    torch.complex128: torch.complex64,
}
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def _is_float(x: torch.Tensor) -> bool:
    return x.dtype.is_floating_point or x.dtype.is_complex


def _promoted(*xs):
    """Operands at their common dtype as ``jnp`` promotes them: every
    tensor takes part whatever its rank (torch would let a 0-d tensor yield
    to a higher-rank one of its kind); Python scalars stay weak."""
    tensors = [x for x in xs if isinstance(x, torch.Tensor)]
    if not tensors:
        return xs
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    dtype = _CANONICAL.get(dtype, dtype)
    return tuple(x.to(dtype) if isinstance(x, torch.Tensor) else x for x in xs)


def _floating(x: torch.Tensor) -> torch.Tensor:
    """An integer operand of a transcendental op as float32, as jnp has it."""
    return x if _is_float(x) else x.to(torch.float32)


def _dims(axis) -> Any:
    """A jnp ``axis`` argument as a torch ``dim`` (a wire list as a tuple)."""
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def _binary(fn: Callable) -> Callable:
    return lambda a, b: fn(*_promoted(a, b))


def _f_matmul(a, b):
    a, b = _promoted(a, b)
    if a.dim() == 0 or b.dim() == 0:
        raise ValueError("matmul: operands must be at least 1-D")
    k_b = b.shape[0] if b.dim() == 1 else b.shape[-2]
    if a.shape[-1] != k_b:
        raise TypeError(f"dot_general requires contracting dimensions to have the same "
                        f"shape, got {tuple(a.shape)} @ {tuple(b.shape)}")
    if _is_float(a):
        return torch.matmul(a, b)
    # integer products wrap at their width as XLA's do: the exact product
    # mod 2^64 taken to the operand width (the card has no integer matmul)
    out = R.ring_matmul_np(a.to(torch.int64), b.to(torch.int64))
    return out != 0 if a.dtype == torch.bool else out.to(a.dtype)


def _f_sum(x, axis=None, keepdims=False):
    if _is_float(x):
        return torch.sum(x, dim=_dims(axis), keepdim=keepdims)
    # jnp sums bools and ints of up to 32 bits at its default int width
    out = torch.sum(x.to(torch.int64), dim=_dims(axis), keepdim=keepdims)
    return out.to(torch.uint32 if x.dtype in _UNSIGNED else torch.int32)


def _f_mean(x, axis=None, keepdims=False):
    return torch.mean(_floating(x), dim=_dims(axis), keepdim=keepdims)


def _f_amax(x, axis=None, keepdims=False):
    return torch.amax(x, dim=() if axis is None else _dims(axis), keepdim=keepdims)


def _f_amin(x, axis=None, keepdims=False):
    return torch.amin(x, dim=() if axis is None else _dims(axis), keepdim=keepdims)


def _f_relu(x):
    # jnp.maximum(x, 0.0): the weak 0.0 keeps a float dtype, lifts ints to f32
    x = _floating(x)
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _f_argmax(x, axis=None, keepdims=False):
    return torch.argmax(x, dim=axis, keepdim=keepdims).to(torch.int32)


def _shape_arg(s: tuple, k: dict) -> tuple:
    return tuple(s) or tuple(k.get("shape"))


# ops resolved as torch calls on resolved tensor args
_ARRAY_OPS: dict[str, Callable] = {
    "__add__": _binary(torch.add), "add": _binary(torch.add),
    "__sub__": _binary(torch.sub), "sub": _binary(torch.sub),
    "__mul__": _binary(torch.mul), "mul": _binary(torch.mul),
    # jnp.divide true-divides integers into float32
    "__truediv__": _binary(torch.true_divide), "div": _binary(torch.true_divide),
    "__matmul__": _f_matmul, "matmul": _f_matmul, "mm": _f_matmul,
    "__neg__": torch.neg,
    "sum": _f_sum, "mean": _f_mean, "max": _f_amax, "min": _f_amin,
    "exp": lambda x: torch.exp(_floating(x)),
    "log": lambda x: torch.log(_floating(x)),
    "tanh": lambda x: torch.tanh(_floating(x)),
    "sqrt": lambda x: torch.sqrt(_floating(x)),
    "abs": torch.abs,
    "sigmoid": lambda x: torch.sigmoid(_floating(x)),
    "relu": _f_relu,
    "t": lambda x: x.transpose(-1, -2),
    "reshape": lambda x, *s, **k: x.reshape(_shape_arg(s, k)),
    "broadcast_to": lambda x, *s, **k: torch.broadcast_to(x, _shape_arg(s, k)).contiguous(),
    "argmax": _f_argmax,
    "softmax": lambda x, axis=-1: torch.softmax(_floating(x), dim=axis),
}

# the ring-safe subset for int64/uint64 operands: torch keeps 64-bit width
# and wraps on overflow — exactly mod-2^64 share arithmetic
_ARRAY_OPS_I64: dict[str, Callable] = {
    "__add__": torch.add, "add": torch.add,
    "__sub__": torch.sub, "sub": torch.sub,
    "__mul__": torch.mul, "mul": torch.mul,
    "__matmul__": R.ring_matmul_np, "matmul": R.ring_matmul_np, "mm": R.ring_matmul_np,
    "__neg__": torch.neg,
    "sum": lambda x, axis=None, keepdims=False: torch.sum(
        x, dim=_dims(axis), keepdim=keepdims),
    # the shape ops are dtype-blind; broadcast_to returns an owned copy,
    # since remote results must own their buffers (broadcast views alias)
    **{k: _ARRAY_OPS[k] for k in ("t", "reshape", "broadcast_to")},
}

# per-type allowlists for method dispatch: everything else is rejected
# (dunder like __setattr__ must never be remotely invokable)
_METHOD_OPS: dict[type, set[str]] = {
    AdditiveSharingTensor: {"__add__", "__sub__", "__mul__", "__matmul__"},
    Plan: set(),  # plans execute only via RunPlanMessage
}


def _refuse_torch_blob(obj: Any) -> None:
    """A worker runs a plan's op list (not code) or an in-process live
    ``fn``, never a plan whose only artifact is a ``torch_blob``: loading
    it is ``torch.export.load``, which can unpickle, and no transport here
    authenticates the host that sent it."""
    if (isinstance(obj, Plan) and obj.fn is None and obj.oplist is None
            and obj.torch_blob is not None):
        raise E.PlanInvalidError(
            "a worker does not run a torch_blob plan from a client: "
            "send a plan with an op list"
        )


def run_received_plan(plan: Plan, args: Sequence[Any], device: torch.device) -> Any:
    """Run a plan a worker or a node was sent: a live ``fn`` (in process
    only), else its op list — never its ``torch_blob``, even when it
    carries one beside the list."""
    _refuse_torch_blob(plan)
    if plan.fn is not None:
        return plan(*args, device=device)
    return plan.run_list(*args, device=device)


def _is_array(v: Any) -> bool:
    return isinstance(v, torch.Tensor) or (
        isinstance(v, (np.ndarray, np.generic)) and np.asarray(v).dtype.kind in "biufcV"
    )


def _rank(v: Any) -> int:
    return v.dim() if isinstance(v, torch.Tensor) else np.ndim(v)


def _is_64bit_int(v: Any) -> bool:
    if isinstance(v, torch.Tensor):
        return v.dtype in (torch.int64, torch.uint64)
    dt = np.asarray(v).dtype
    return dt.kind in "iu" and dt.itemsize == 8


def _is_uint64(v: Any) -> bool:
    if isinstance(v, torch.Tensor):
        return v.dtype == torch.uint64
    return np.asarray(v).dtype == np.uint64


class VirtualWorker:
    """A named party on ``device`` (default ``"cuda"``; without a GPU that
    raises unless the caller passes ``device="cpu"``): object store +
    message router + known-worker mesh."""

    def __init__(self, id: str, device: str | torch.device = "cuda") -> None:
        self.id = str(id)
        self.device = resolve(device)
        self.store = ObjectStore(self.id)
        self._known_workers: dict[str, "VirtualWorker"] = {}
        #: set to a CryptoProvider to make this worker a triple dealer
        #: (the reference's crypto-provider node, e.g. "james" in
        #: test_basic_syft_operations.py:455-491)
        self.crypto_provider = None
        self._message_router: dict[type, Callable] = {
            M.ObjectMessage: self._handle_object,
            M.ObjectRequestMessage: self._handle_object_request,
            M.ForceObjectDeleteMessage: self._handle_delete,
            M.TensorCommandMessage: self._handle_command,
            M.RunPlanMessage: self._handle_run_plan,
            M.SearchMessage: self._handle_search,
            M.IsNoneMessage: self._handle_is_none,
            M.GetShapeMessage: self._handle_shape,
            M.CryptoRequestMessage: self._handle_crypto_request,
            M.CryptoProvideMessage: self._handle_crypto_provide,
        }

    # --- mesh ---------------------------------------------------------------

    def add_worker(self, other: "VirtualWorker") -> None:
        self._known_workers[other.id] = other
        other._known_workers[self.id] = self

    # --- placement ------------------------------------------------------------

    def place(self, value: Any) -> Any:
        """``value`` as this worker keeps it: a torch tensor or a numeric
        numpy array (raw ``|V2`` bfloat16 values included) as a tensor on
        the worker's device at its own dtype; anything else as it is."""
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        if not _is_array(value):
            return value
        arr = np.asarray(value)
        if arr.dtype.kind == "V":
            if arr.dtype.itemsize != 2:
                return value
            return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(self.device)
        # a writable C-ordered copy: wire arrays are read-only views
        return torch.from_numpy(np.array(arr, order="C")).to(self.device)

    # --- transport entry points --------------------------------------------

    def _recv_msg(self, blob: bytes | bytearray, user: str | None = None) -> bytes:
        """Binary frame in, binary frame out (the reference's entry point).

        Every failure — typed grid errors and routine execution errors (shape
        mismatches etc.) — serializes to a typed ErrorResponse frame; nothing
        may escape and kill the server's frame handler. Registered objects
        that hold tensors (an ``AdditiveSharingTensor``) decode onto the
        worker's device.
        """
        try:
            msg = deserialize(blob, device=self.device)
        except Exception as err:  # noqa: BLE001 — transport boundary
            return serialize(
                M.ErrorResponse(error_type=type(err).__name__, message=str(err))
            )
        return self.recv_decoded_msg(msg, user=user)

    def recv_decoded_msg(self, msg: Any, user: str | None = None) -> bytes:
        """Dispatch an already-deserialized message; same error framing as
        ``_recv_msg``."""
        try:
            response = self.recv_obj_msg(msg, user=user)
        except E.EmptyCryptoPrimitiveStoreError as err:
            response = M.ErrorResponse(
                error_type="EmptyCryptoPrimitiveStoreError",
                data=dict(err.kwargs_),
            )
        except E.PyGridError as err:
            response = M.ErrorResponse(
                error_type=type(err).__name__, message=str(err)
            )
        except Exception as err:  # noqa: BLE001 — transport boundary
            response = M.ErrorResponse(
                error_type=type(err).__name__, message=str(err)
            )
        return serialize(response)

    def recv_obj_msg(self, msg: Any, user: str | None = None) -> Any:
        handler = self._message_router.get(type(msg))
        if handler is None:
            raise E.PyGridError(f"unknown message type {type(msg).__name__}")
        return handler(msg, user)

    # --- argument resolution ------------------------------------------------

    def _resolve(self, v: Any, user: str | None, sources: list | None = None):
        """Deref ``{"__ref__": id}`` args. Every deref is permission-checked
        against the session user — computing on a private tensor would
        otherwise be a laundering bypass of GetNotPermittedError."""
        if M.is_ref(v):
            obj = self.store.get_obj(v["__ref__"])
            obj.check_access(user)
            if sources is not None:
                sources.append(obj)
            return obj.value
        if isinstance(v, list):
            return [self._resolve(x, user, sources) for x in v]
        return v

    @staticmethod
    def _derived_permissions(sources: list) -> set[str] | None:
        """Results inherit the most restrictive source policy: intersection
        of all non-public allowed_users sets (None == public)."""
        allowed: set[str] | None = None
        for obj in sources:
            if obj.allowed_users is not None:
                allowed = (
                    set(obj.allowed_users)
                    if allowed is None
                    else allowed & obj.allowed_users
                )
        return allowed

    # --- handlers -----------------------------------------------------------

    def _handle_object(self, msg: M.ObjectMessage, user: str | None):
        _refuse_torch_blob(msg.obj)
        # id-reuse rejection lives in ObjectStore.set_obj, covering every
        # path that stores at a client-chosen id (object push, command
        # return_id, plan return_id)
        obj = self.store.set_obj(
            value=self.place(msg.obj),
            id=msg.id,
            tags=msg.tags,
            description=msg.description,
            allowed_users=msg.allowed_users,
            garbage_collect_data=msg.garbage_collect_data,
        )
        shape = list(getattr(msg.obj, "shape", ()) or ())
        return M.PointerResponse(
            id_at_location=obj.id, location=self.id, shape=shape, tags=msg.tags
        )

    def _handle_object_request(self, msg: M.ObjectRequestMessage, user: str | None):
        obj = self.store.get_obj(msg.obj_id)
        obj.check_access(user)
        value = obj.value
        if msg.delete and obj.garbage_collect_data:
            self.store.rm_obj(msg.obj_id)
        return value

    def _handle_delete(self, msg: M.ForceObjectDeleteMessage, user: str | None):
        if msg.obj_id in self.store:
            # the destructive path is permission-gated like the read path
            self.store.get_obj(msg.obj_id).check_access(user)
            self.store.rm_obj(msg.obj_id)
        return {"status": "ok"}

    def _handle_command(self, msg: M.TensorCommandMessage, user: str | None):
        if msg.op == "send_to":
            return self._handle_move(msg, user)
        sources: list = []
        args = [self._resolve(a, user, sources) for a in msg.args]
        kwargs = {k: self._resolve(v, user, sources) for k, v in msg.kwargs.items()}
        result = self._execute_op(msg.op, args, kwargs)
        obj = self.store.set_obj(
            result,
            id=msg.return_id,
            allowed_users=self._derived_permissions(sources),
        )
        return M.PointerResponse(
            id_at_location=obj.id,
            location=self.id,
            shape=list(getattr(result, "shape", ()) or ()),
        )

    def _handle_move(self, msg: M.TensorCommandMessage, user: str | None):
        """Worker→worker move: full StoredObject metadata travels with the
        value (a private tensor must stay private on the target), origin copy
        is removed, and the target's pointer is the response."""
        if not (msg.args and M.is_ref(msg.args[0])):
            raise E.PyGridError("send_to requires an object reference")
        target_id = msg.kwargs.get("worker")
        target = self._known_workers.get(target_id)
        if target is None:
            raise E.WorkerNotFoundError()
        obj = self.store.get_obj(msg.args[0]["__ref__"])
        obj.check_access(user)
        resp = target.recv_obj_msg(
            M.ObjectMessage(
                obj=obj.value,
                tags=sorted(obj.tags),
                description=obj.description,
                allowed_users=(
                    sorted(obj.allowed_users)
                    if obj.allowed_users is not None
                    else None
                ),
                garbage_collect_data=obj.garbage_collect_data,
            ),
            user=user,
        )
        self.store.rm_obj(obj.id)  # a move leaves no copy behind
        return resp

    def _execute_op(self, op: str, args: list, kwargs: dict) -> Any:
        first = args[0] if args else None
        for typ, allowed_ops in _METHOD_OPS.items():
            if isinstance(first, typ):
                if op not in allowed_ops:
                    raise E.PyGridError(
                        f"{typ.__name__} does not support remote op {op!r}"
                    )
                return getattr(first, op)(*args[1:], **kwargs)
        # 64-bit integer tensors (SMPC ring shares travel as int64) keep full
        # width and wrap mod 2^64. Only non-scalar operands count: Python int
        # scalars arrive as 0-d int64 and must not hijack float-tensor ops
        # like ``ptr / 2``.
        tensor_args = [a for a in args if _is_array(a) and _rank(a) >= 1]
        if tensor_args and all(_is_64bit_int(a) for a in tensor_args):
            fn = _ARRAY_OPS_I64.get(op)
            if fn is None:
                raise E.PyGridError(
                    f"op {op!r} not permitted on 64-bit integer tensors"
                )
            unsigned = all(_is_uint64(a) for a in tensor_args)
            out = fn(*[self._ring_operand(a) for a in args], **kwargs)
            return out.view(torch.uint64) if unsigned else out
        fn = _ARRAY_OPS.get(op)
        if fn is None:
            raise E.PyGridError(f"op {op!r} not permitted")
        args = [self._float_operand(a) for a in args]
        if not any(isinstance(a, torch.Tensor) for a in args) and args:
            args[0] = self._scalar_tensor(args[0])
        return fn(*args, **kwargs)

    def _ring_operand(self, a: Any) -> Any:
        """A ring-path operand on the worker's device, uint64 as its int64
        bits (torch has few uint64 ops; the ring arithmetic is the same)."""
        if not _is_array(a):
            return a
        t = self.place(a)
        return t.view(torch.int64) if t.dtype == torch.uint64 else t

    def _float_operand(self, a: Any) -> Any:
        """A float-path operand as ``jnp.asarray`` makes it: on the device,
        64-bit types at 32 bits."""
        if not _is_array(a):
            return a
        t = self.place(a)
        return t.to(_CANONICAL.get(t.dtype, t.dtype))

    def _scalar_tensor(self, x: Any) -> Any:
        """A Python scalar first operand as the 0-d array jnp makes of it."""
        if isinstance(x, bool):
            return torch.tensor(x, device=self.device)
        if isinstance(x, int):
            return torch.tensor(x, dtype=torch.int32, device=self.device)
        if isinstance(x, float):
            return torch.tensor(x, dtype=torch.float32, device=self.device)
        return x

    def _handle_run_plan(self, msg: M.RunPlanMessage, user: str | None):
        obj = self.store.get_obj(msg.plan_id)
        obj.check_access(user)  # a private Plan is a private model
        plan = obj.value
        if not isinstance(plan, Plan):
            raise E.PlanNotFoundError(f"object {msg.plan_id} is not a Plan")
        sources: list = [obj]
        args = [self._resolve(a, user, sources) for a in msg.args]
        result = run_received_plan(plan, args, self.device)
        stored = self.store.set_obj(
            result,
            id=msg.return_id,
            allowed_users=self._derived_permissions(sources),
        )
        return M.PointerResponse(
            id_at_location=stored.id,
            location=self.id,
            shape=list(getattr(result, "shape", ()) or ()),
        )

    # --- crypto-provider plane (cross-node Beaver dealing) -------------------

    def _require_provider(self):
        if self.crypto_provider is None:
            raise E.PyGridError(f"worker {self.id!r} is not a crypto provider")
        return self.crypto_provider

    def _handle_crypto_request(self, msg: M.CryptoRequestMessage, user: str | None):
        """Deal one primitive on the provider's device: generate (or pop
        from the strict store — may raise ``EmptyCryptoPrimitiveStoreError``,
        which ``_recv_msg`` serializes back with the refill kwargs), then push
        each party's int64 slice, as it is, to the party workers over the
        known-worker mesh (each party moves it to its own device)."""
        provider = self._require_provider()
        n = len(msg.party_ids)
        if n < 2:
            raise E.PyGridError("need at least 2 parties")
        # resolve every target BEFORE drawing the primitive: a bad party id
        # must not consume strict-store stock
        targets = []
        for pid in msg.party_ids:
            target = self if pid == self.id else self._known_workers.get(pid)
            if target is None:
                raise E.WorkerNotFoundError(f"unknown party worker {pid!r}")
            targets.append(target)
        if msg.op == "trunc":
            components = provider.trunc_pair(
                tuple(msg.shape_x), int(msg.shape_y[0]), n
            )
        else:
            components = provider.triple(
                msg.op, tuple(msg.shape_x), tuple(msg.shape_y), n
            )
        ids: list[list[int]] = []
        pushed: list[tuple[Any, int]] = []  # (target, obj_id) for rollback
        try:
            for i, target in enumerate(targets):
                row = []
                for stacked in components:
                    resp = target.recv_obj_msg(
                        M.ObjectMessage(obj=stacked[i]), user=user
                    )
                    if isinstance(resp, M.ErrorResponse):
                        raise E.PyGridError(
                            f"dealing to {msg.party_ids[i]!r} failed: "
                            f"{resp.message}"
                        )
                    row.append(resp.id_at_location)
                    pushed.append((target, resp.id_at_location))
                ids.append(row)
        except Exception:
            for target, obj_id in pushed:  # best-effort: no orphaned shares
                try:
                    target.recv_obj_msg(
                        M.ForceObjectDeleteMessage(obj_id=obj_id), user=user
                    )
                except Exception:  # noqa: BLE001 — cleanup path
                    pass
            raise
        return M.CryptoDealResponse(party_ids=list(msg.party_ids), ids=ids)

    def _handle_crypto_provide(self, msg: M.CryptoProvideMessage, user: str | None):
        provider = self._require_provider()
        provider.provide(
            msg.op,
            tuple(msg.shape_x),
            tuple(msg.shape_y),
            msg.n_parties,
            msg.n_instances,
        )
        return {"status": "ok"}

    @staticmethod
    def _visible_to(obj: StoredObject, user: str | None) -> bool:
        return obj.allowed_users is None or user in obj.allowed_users

    def _handle_search(self, msg: M.SearchMessage, user: str | None):
        # private objects are invisible to other users: even their ids/shapes
        # would leak handles for probing
        found = [o for o in self.store.search(msg.query) if self._visible_to(o, user)]
        return [
            M.PointerResponse(
                id_at_location=o.id,
                location=self.id,
                shape=list(getattr(o.value, "shape", ()) or ()),
                tags=sorted(o.tags),
            )
            for o in found
        ]

    def _handle_is_none(self, msg: M.IsNoneMessage, user: str | None):
        if msg.obj_id not in self.store:
            return True
        # inaccessible == indistinguishable from absent
        return not self._visible_to(self.store.get_obj(msg.obj_id), user)

    def _handle_shape(self, msg: M.GetShapeMessage, user: str | None):
        obj = self.store.get_obj(msg.obj_id)
        obj.check_access(user)
        return list(getattr(obj.value, "shape", ()) or ())

    # --- convenience (syft-style local API) ---------------------------------

    def search(self, *query: str) -> list[StoredObject]:
        return self.store.search(query)

    def __repr__(self) -> str:
        return (f"VirtualWorker(id={self.id!r}, device={str(self.device)!r}, "
                f"objects={len(self.store)})")
