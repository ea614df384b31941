"""Carry flat param lists and SMPC ring values between numpy and the port.

The JAX package's params come across as numpy arrays — for example
``[np.asarray(p) for p in transformer.init(key, cfg)]`` — and go back the
same way, so a parity test hands both packages the same weights. Each
array's shape is checked against the model's flat layout first.

Ring values (shares, Beaver triples, truncation pairs) cross the same way:
the JAX package holds one as a ``Ring64(lo, hi)`` pair of uint32 arrays,
the port as one int64 tensor with the same 64 bits
(:func:`ring_from_numpy`, :func:`ring_to_numpy`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.models import mlp, transformer


def expected_shapes(
    cfg: transformer.TransformerConfig | None = None,
    mlp_sizes: Sequence[int] | None = None,
) -> list[tuple[int, ...]]:
    """The flat param shapes of a transformer ``cfg`` or an MLP of
    ``mlp_sizes`` (exactly one of the two)."""
    if (cfg is None) == (mlp_sizes is None):
        raise ValueError("pass exactly one of cfg (transformer) or mlp_sizes (MLP)")
    if cfg is not None:
        return transformer.param_shapes(cfg)
    return mlp.param_shapes(mlp_sizes)


def _check(shapes: list[tuple[int, ...]], expected: list[tuple[int, ...]]) -> None:
    if len(shapes) != len(expected):
        raise ValueError(f"expected {len(expected)} params, got {len(shapes)}")
    for i, (got, want) in enumerate(zip(shapes, expected)):
        if tuple(got) != tuple(want):
            raise ValueError(f"param {i}: shape {tuple(got)} does not match {tuple(want)}")


def params_from_numpy(
    arrays: Sequence[np.ndarray],
    device: str | torch.device = "cuda",
    *,
    cfg: transformer.TransformerConfig | None = None,
    mlp_sizes: Sequence[int] | None = None,
) -> list[torch.Tensor]:
    """numpy params → tensors on ``device`` (copies; dtypes kept)."""
    dev = resolve(device)
    arrays = [np.asarray(a) for a in arrays]
    _check([a.shape for a in arrays], expected_shapes(cfg, mlp_sizes))
    return [torch.from_numpy(np.array(a, copy=True)).to(dev) for a in arrays]


def params_to_numpy(
    params: Sequence[torch.Tensor],
    *,
    cfg: transformer.TransformerConfig | None = None,
    mlp_sizes: Sequence[int] | None = None,
) -> list[np.ndarray]:
    """Tensors → numpy arrays on the host (dtypes kept)."""
    _check([tuple(p.shape) for p in params], expected_shapes(cfg, mlp_sizes))
    return [p.detach().cpu().numpy() for p in params]


def ring_from_numpy(ring, device: str | torch.device = "cuda"):
    """The JAX package's ring values → the port's int64 tensors on ``device``.

    ``ring`` is one ``(lo, hi)`` pair of uint32 arrays (a ``Ring64``, or
    its numpy arrays: one share tensor) and gives one tensor, or a sequence
    of such pairs (a triple ``(a, b, c)``, a truncation pair ``(r, r')``)
    and gives a tuple of tensors."""
    dev = resolve(device)
    if isinstance(ring[0], tuple):
        return tuple(ring_from_numpy(r, dev) for r in ring)
    lo, hi = (np.asarray(x) for x in ring)
    if lo.dtype != np.uint32 or hi.dtype != np.uint32 or lo.shape != hi.shape:
        raise ValueError(
            f"a ring value is a (lo, hi) pair of uint32 arrays of one shape, got "
            f"{lo.dtype}{lo.shape} and {hi.dtype}{hi.shape}"
        )
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return torch.from_numpy(v.view(np.int64)).to(dev)


def ring_to_numpy(x):
    """The port's int64 ring tensor → a ``(lo, hi)`` pair of uint32 arrays
    (``Ring64``'s layout); a sequence of tensors gives a tuple of pairs."""
    if isinstance(x, (tuple, list)):
        return tuple(ring_to_numpy(t) for t in x)
    v = x.detach().cpu().numpy().view(np.uint64)
    return (v & np.uint64(0xFFFFFFFF)).astype(np.uint32), (v >> np.uint64(32)).astype(np.uint32)
