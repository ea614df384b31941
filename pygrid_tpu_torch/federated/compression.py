"""Sparse diff compression for the FL report path — top-k with error
feedback (Lin et al., "Deep Gradient Compression"; Stich et al. on error
feedback). No reference analog: the reference always ships dense diffs.

A worker keeps only the k·N largest-magnitude entries per parameter tensor
(small tensors stay dense — indices would cost more than values), carries
the discarded remainder as a residual into its next report, and ships
``{indices, values}`` per tensor. The node densifies on ingest and the
aggregation path is unchanged — compression is a wire/storage format, not
a different algorithm.

Configured per process: ``client_config["diff_compression"] =
{"name": "topk", "fraction": 0.1}`` — workers then upload ~10% of the
bytes (less with the bf16 wire).

The port's copy of :mod:`pygrid_tpu.federated.compression`, with the port's imports.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from pygrid_tpu_torch.utils.exceptions import PyGridError

#: tensors at or below this many elements ship dense — int32 indices plus
#: values would exceed the dense payload
MIN_SPARSE_ELEMENTS = 1024

_MAGIC = "__pygrid_sparse_diff__"


def topk_compress(
    diffs: Sequence[np.ndarray],
    fraction: float,
    residual: Sequence[np.ndarray] | None = None,
) -> tuple[dict, list[np.ndarray]]:
    """Compress a diff list; returns ``(payload, new_residual)``.

    ``residual`` (the entries previous rounds dropped) is folded in before
    selection — without error feedback, persistent small coordinates would
    never be transmitted and top-k FL converges measurably worse.
    """
    if not 0.0 < fraction <= 1.0:
        raise PyGridError(f"topk fraction must be in (0, 1], got {fraction}")
    payload: dict[str, Any] = {_MAGIC: True, "tensors": []}
    new_residual: list[np.ndarray] = []
    for i, d in enumerate(diffs):
        d = np.asarray(d, dtype=np.float32)
        if residual is not None:
            d = d + np.asarray(residual[i], dtype=np.float32)
        if d.size <= MIN_SPARSE_ELEMENTS:
            payload["tensors"].append({"dense": d})
            new_residual.append(np.zeros_like(d))
            continue
        k = max(1, int(round(d.size * fraction)))
        flat = d.ravel()
        idx = np.argpartition(np.abs(flat), -k)[-k:].astype(np.int32)
        values = flat[idx]
        payload["tensors"].append(
            {"shape": list(d.shape), "indices": idx, "values": values}
        )
        res = d.copy()
        res.ravel()[idx] = 0.0
        new_residual.append(res)
    return payload, new_residual


def is_sparse_diff(obj: Any) -> bool:
    return isinstance(obj, dict) and obj.get(_MAGIC) is True


#: densify refuses shapes above this many elements (~1 GB f32): the wire
#: payload is worker-supplied, and a few-hundred-byte envelope must not be
#: able to demand a multi-TB allocation
MAX_DENSE_ELEMENTS = 1 << 28


def topk_decompress(payload: dict) -> list[np.ndarray]:
    """Densify a compressed diff (node-side ingest). Every field is
    worker-supplied — validated, not trusted."""
    out: list[np.ndarray] = []
    for t in payload.get("tensors", []):
        if "dense" in t:
            out.append(np.asarray(t["dense"], dtype=np.float32))
            continue
        shape = tuple(int(s) for s in t["shape"])
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if not shape or n <= 0 or n > MAX_DENSE_ELEMENTS:
            raise PyGridError(f"sparse diff shape {shape} out of bounds")
        indices = np.asarray(t["indices"], dtype=np.int64).ravel()
        values = np.asarray(t["values"], dtype=np.float32).ravel()
        if indices.shape != values.shape:
            raise PyGridError("sparse diff indices/values length mismatch")
        if indices.size and (
            indices.min() < 0 or indices.max() >= n
        ):
            raise PyGridError("sparse diff indices out of range")
        dense = np.zeros(n, dtype=np.float32)
        dense[indices] = values
        out.append(dense.reshape(shape))
    return out


def decode_diff(blob: bytes) -> list[np.ndarray]:
    """Node-side diff ingest: dense States and sparse envelopes, one door.

    (Reference ingest is `unserialize_model_params` only —
    model_manager.py:95-103; the sparse envelope is this framework's wire
    extension.)"""
    from pygrid_tpu_torch.serde import deserialize
    from pygrid_tpu_torch.plans.state import State

    obj = deserialize(blob)
    if is_sparse_diff(obj):
        return topk_decompress(obj)
    if isinstance(obj, State):
        return obj.tensors()
    raise PyGridError("diff blob is neither a State nor a sparse diff")
