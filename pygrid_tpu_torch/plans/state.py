"""State — the model-parameter container that crosses the wire: the port's
own copy of :mod:`pygrid_tpu.plans.state`, under the same wire name.

Parity surface: syft ``State`` as consumed by the reference's ModelManager
(``models/model_manager.py:80-103``): ``serialize_model_params`` wraps a list
of tensors in placeholders and protobuf-serializes; ``unserialize_model_params``
returns ``state.tensors()``. Here a State is an ordered list of
:class:`PlaceHolder` — i.e. a flattened pytree leaf list with stable ids — and
serde rides :mod:`pygrid_tpu_torch.serde`. The model-level helpers take torch
tensors on any device (or numpy) and hand tensors back on the device asked for.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np

import torch

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.plans.placeholder import PlaceHolder
from pygrid_tpu_torch.serde import deserialize, register_serde, serialize


@register_serde(name="pygrid.State")
class State:
    __slots__ = ("state_placeholders",)

    def __init__(self, state_placeholders: Iterable[PlaceHolder] = ()) -> None:
        self.state_placeholders = list(state_placeholders)

    @classmethod
    def from_tensors(cls, tensors: Sequence[Any]) -> "State":
        return cls([PlaceHolder().instantiate(t) for t in tensors])

    def tensors(self) -> list[Any]:
        return [ph.tensor for ph in self.state_placeholders]

    def _bufferize(self) -> dict:
        return {"placeholders": self.state_placeholders}

    @classmethod
    def _unbufferize(cls, data: dict) -> "State":
        return cls(data["placeholders"])

    def __len__(self) -> int:
        return len(self.state_placeholders)

    def __repr__(self) -> str:
        return f"State({self.state_placeholders!r})"


def serialize_model_params(params: Sequence[Any], *, bf16: bool = False) -> bytes:
    """list of tensors -> wire bytes (reference model_manager.py:80-92).

    Torch tensors on any device (serde copies each to the host once) or
    numpy arrays. ``bf16=True`` ships float32 params as bfloat16 bit
    patterns (half the upload bytes; the FL diff path opts in via
    client_config)."""
    leaves = [p if isinstance(p, torch.Tensor) else np.asarray(p) for p in params]
    return serialize(State.from_tensors(leaves), bf16_floats=bf16)


def unserialize_model_params(blob: bytes, device: str | torch.device = "cuda") -> list[torch.Tensor]:
    """wire bytes -> list of tensors on ``device`` (reference
    model_manager.py:95-103). Default ``"cuda"``: raises without a GPU
    unless ``device="cpu"``. Each tensor is a fresh copy (the decoded
    arrays are read-only views of ``blob``)."""
    dev = resolve(device)
    state = deserialize(blob)
    if not isinstance(state, State):
        raise TypeError("blob does not contain a State")
    return [_to_tensor(t, dev) for t in state.tensors()]


def _to_tensor(arr: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype == np.dtype("V2"):  # raw bf16 values, as serde wrote them
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def host_model_params(blob: bytes) -> list[np.ndarray]:
    """wire bytes -> list of host numpy arrays: what the reference's
    ``unserialize_model_params`` returns. The node's cycle manager folds
    and averages diffs where they land, in host RAM, so it decodes with
    this and never places a checkpoint on a device."""
    state = deserialize(blob)
    if not isinstance(state, State):
        raise TypeError("blob does not contain a State")
    return state.tensors()
