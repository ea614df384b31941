"""Plan — a traced, serializable, executable program: the port's counterpart
of :mod:`pygrid_tpu.plans.plan`, under the same wire name ``pygrid.Plan``.

A port Plan runs plans of two origins.

- **Decoded from a JAX package blob.** All eight fields of the reference's
  ``_bufferize`` are kept. ``exported_blob`` (``jax.export`` StableHLO)
  stays opaque bytes the port never executes; a call runs ``oplist``, the
  portable ``"list"`` dialect, through
  :func:`~pygrid_tpu_torch.plans.translators.run_oplist` on the card.
  Serialising such a plan again gives the JAX package's bytes, so a port
  node serves a JAX client exactly what a JAX node would.
- **Built from a torch function.** :meth:`Plan.build` traces the function
  with ``make_fx`` (a ``torch.func.grad`` inside becomes plain ATen ops),
  exports the graph with ``torch.export`` and keeps the ``torch.export.save``
  bytes under a ninth wire key, ``torch_blob`` — the ``"torchscript"``
  variant, the reference's own name for it. ``code`` is the graph's
  readable code, and ``oplist`` the decomposed program lowered to the
  portable dialect (:func:`~pygrid_tpu_torch.plans.translators.fx_to_oplist`),
  so a JAX node, a JAX or numpy client and the encrypted interpreter run
  the plan as they run a JAX-built one.

A call prefers a live ``fn``, then ``torch_blob``, then ``oplist``. A plan
traced on a host runs on the card: the devices baked into the exported
graph (``ones_like``, ``full``, ``scalar_tensor`` carry ``device=``) are
rewritten to the call's device when the program is loaded.

``torch.export.load`` can fall back to unpickling, so a ``torch_blob`` is
trusted input (``jax.export`` bytes are not code): take plans only from an
authenticated host. A plan that came off the wire from anyone else runs
through :meth:`Plan.run_list`, its op list alone.
"""

from __future__ import annotations

import io
import uuid
from typing import Any, Callable, Sequence

import numpy as np
import torch

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.plans.state import State
from pygrid_tpu_torch.plans.translators import fx_to_oplist, run_oplist
from pygrid_tpu_torch.serde import register_serde
from pygrid_tpu_torch.utils.exceptions import PlanInvalidError


def _lift(x: Any, device: torch.device) -> torch.Tensor:
    """A plan input as a tensor on ``device``, its dtype kept (a Python
    float is float32, as the traced example's scalars are)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, float):
        return torch.tensor(x, dtype=torch.float32, device=device)
    arr = np.asarray(x)
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr, order="C")  # a writable copy without negative strides
    return torch.from_numpy(arr).to(device)


def _on_device(program: torch.fx.GraphModule, device: torch.device) -> torch.fx.GraphModule:
    """Rewrite every device the exported graph carries (factory kwargs,
    metadata asserts, constant attributes) to ``device``."""

    def move(v):
        if isinstance(v, torch.device):
            return device
        if isinstance(v, (list, tuple)):
            return type(v)(move(x) for x in v)
        return v

    for node in program.graph.nodes:
        node.args = move(node.args)
        node.kwargs = {k: move(v) for k, v in node.kwargs.items()}
        if node.op == "get_attr":
            owner, _, name = node.target.rpartition(".")
            mod = program.get_submodule(owner) if owner else program
            val = getattr(mod, name)
            if isinstance(val, torch.Tensor) and val.device != device:
                setattr(mod, name, val.to(device))
    program.recompile()
    return program.to(device)


@register_serde(name="pygrid.Plan")
class Plan:
    """A built plan. Call it like a function, with ``device=``."""

    def __init__(
        self,
        name: str = "",
        id: str | None = None,
        fn: Callable | None = None,
        state: State | None = None,
        input_specs: list[dict] | None = None,
        exported_blob: bytes | None = None,
        oplist: dict | None = None,
        code: str = "",
        torch_blob: bytes | None = None,
    ) -> None:
        self.name = name
        self.id = id or uuid.uuid4().hex
        self.fn = fn
        self.state = state if state is not None else State()
        #: how many trailing plan inputs are fed from ``self.state`` (state
        #: tensors are implicit inputs appended at call time, so updating
        #: plan.state between FL rounds changes execution)
        self.n_state_inputs = 0
        self.input_specs = input_specs or []
        self.exported_blob = exported_blob
        self.oplist = oplist
        self.code = code
        self.torch_blob = torch_blob
        self._programs: dict[torch.device, torch.fx.GraphModule] = {}
        # "built" means a wire artifact exists — a live fn alone is not
        # built until .build() captures the exported program
        self.is_built = exported_blob is not None or torch_blob is not None

    # --- build -------------------------------------------------------------

    def build(self, *example_args: Any) -> "Plan":
        """Trace ``fn`` on example args on the host and capture the
        ``torch.export`` program and its op list (a function with an op
        that has no lowering raises here, naming it). If the plan carries a
        State, its tensors are appended as trailing inputs and injected at
        call time."""
        if self.fn is None:
            raise PlanInvalidError("Plan has no function to build")
        from torch.fx.experimental.proxy_tensor import make_fx

        cpu = torch.device("cpu")
        state_tensors = [_lift(t, cpu) for t in self.state.tensors()]
        self.n_state_inputs = len(state_tensors)
        example = tuple(_lift(a, cpu) for a in example_args) + tuple(state_tensors)
        graph = make_fx(self.fn)(*example)
        self.code = graph.code
        exported = torch.export.export(graph, example, strict=False)
        self.oplist = fx_to_oplist(exported.run_decompositions())
        exported.example_inputs = None  # the blob carries the program, not the params
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        self.torch_blob = buf.getvalue()
        self._programs.clear()
        self.input_specs = [
            {"shape": list(a.shape), "dtype": str(a.dtype).removeprefix("torch.")}
            for a in example
        ]
        self.is_built = True
        return self

    # --- execute -----------------------------------------------------------

    def _program(self, device: torch.device) -> torch.fx.GraphModule:
        program = self._programs.get(device)
        if program is None:
            exported = torch.export.load(io.BytesIO(self.torch_blob))
            program = self._programs[device] = _on_device(exported.module(), device)
        return program

    def __call__(self, *args: Any, device: str | torch.device = "cuda"):
        """Run the plan on ``device`` (default ``"cuda"``; without a GPU
        that raises unless the caller passes ``device="cpu"``)."""
        dev = resolve(device)
        if self.fn is None and self.torch_blob is None:
            return self.run_list(*args, device=dev)
        if self.n_state_inputs:
            args = tuple(args) + tuple(self.state.tensors())
        if self.fn is not None:
            return self.fn(*[_lift(a, dev) for a in args])
        return self._program(dev)(*[_lift(a, dev) for a in args])

    def run_list(self, *args: Any, device: str | torch.device = "cuda"):
        """Run the op list alone, never ``fn`` or ``torch_blob``: how a
        plan that came off the wire runs on a worker or a node."""
        if self.oplist is None:
            raise PlanInvalidError("Plan is not built" if not self.is_built
                                   else "Plan has no op list")
        if self.n_state_inputs:
            args = tuple(args) + tuple(self.state.tensors())
        return run_oplist(self.oplist, *args, backend="torch", device=device)

    # --- serde -------------------------------------------------------------

    def _bufferize(self) -> dict:
        # the reference's eight keys in its order (a JAX-built plan
        # re-serializes byte for byte); torch_blob only when set
        data = {
            "name": self.name,
            "id": self.id,
            "state": self.state,
            "n_state_inputs": self.n_state_inputs,
            "input_specs": self.input_specs,
            "exported_blob": self.exported_blob,
            "oplist": self.oplist,
            "code": self.code,
        }
        if self.torch_blob is not None:
            data["torch_blob"] = self.torch_blob
        return data

    @classmethod
    def _unbufferize(cls, data: dict) -> "Plan":
        plan = cls(
            name=data["name"],
            id=data["id"],
            state=data["state"],
            input_specs=data["input_specs"],
            exported_blob=data["exported_blob"],
            oplist=data["oplist"],
            code=data["code"],
            torch_blob=data.get("torch_blob"),
        )
        plan.n_state_inputs = data.get("n_state_inputs", 0)
        return plan

    def __repr__(self) -> str:
        return (
            f"Plan(name={self.name!r}, id={self.id!r}, built={self.is_built}, "
            f"inputs={self.input_specs})"
        )


def func2plan(
    args_shape: Sequence[Sequence[int]],
    state: Sequence[Any] | None = None,
    args_dtypes: Sequence[Any] | None = None,
    name: str | None = None,
):
    """Decorator: trace a python function into a built :class:`Plan`
    (syft's ``@sy.func2plan(args_shape=..., state=...)``). ``args_shape``
    gives example input shapes (zeros are the tracing exemplars, float32
    unless ``args_dtypes`` says otherwise); ``state`` optionally attaches
    model parameters carried with the plan."""

    def decorator(fn: Callable) -> Plan:
        dtypes = list(args_dtypes or [np.float32] * len(args_shape))
        example_args = [
            np.zeros(tuple(s), dtype=d) for s, d in zip(args_shape, dtypes)
        ]
        plan = Plan(name=name or fn.__name__, fn=fn)
        if state is not None:
            plan.state = State.from_tensors(list(state))
        plan.build(*example_args)
        return plan

    return decorator
