"""Carry flat param lists between numpy and the port.

The JAX package's params come across as numpy arrays — for example
``[np.asarray(p) for p in transformer.init(key, cfg)]`` — and go back the
same way, so a parity test hands both packages the same weights. Each
array's shape is checked against the model's flat layout first.
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
