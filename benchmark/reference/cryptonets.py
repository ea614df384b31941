"""Plain float64 CryptoNets MLP over fixed-point values.

affine → square → affine, the op list of the encrypted plan. The inputs
and weights are first rounded to the fixed-point grid that the encrypted
path shares them on (``round(v · base^precision)`` of the float64 value,
half to even, as NumPy rounds), so what is left between the decoded
prediction and this is the protocol's own error: its truncations.
"""

from __future__ import annotations

import numpy as np
import torch


def on_grid(v, base: int = 10, precision: int = 3, device="cpu") -> torch.Tensor:
    scale = float(base ** precision)
    t = torch.as_tensor(np.asarray(v), device=device).double()
    return torch.round(t * scale) / scale


def forward(x, w1, b1, w2, b2, base: int = 10, precision: int = 3, device="cpu") -> np.ndarray:
    """The prediction for host arrays, computed in float64 on ``device``."""
    x, w1, b1, w2, b2 = (on_grid(v, base, precision, device) for v in (x, w1, b1, w2, b2))
    h = x @ w1 + b1
    return ((h * h) @ w2 + b2).cpu().numpy()
