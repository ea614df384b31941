"""Fixed-precision encoding into the 2^64 ring.

Counterpart of :mod:`pygrid_tpu.smpc.fixed` (syft's ``FixedPrecisionTensor``
``.fix_prec()`` / ``.float_prec()``): base-10 encoding with
``precision_fractional=3`` by default, signed values in two's complement
mod 2^64. Encoding runs on the host in float64 and rounds as ``np.round``
does (half to even), as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from pygrid_tpu_torch.smpc.ring import from_ring_signed, ring_div_const_signed, to_ring

DEFAULT_BASE = 10
DEFAULT_PRECISION = 3


class FixedPointEncoder:
    def __init__(
        self, base: int = DEFAULT_BASE, precision_fractional: int = DEFAULT_PRECISION
    ) -> None:
        if base ** precision_fractional >= (1 << 16):
            raise ValueError(
                "scale must stay < 2^16 so truncation's limb division is exact"
            )
        self.base = base
        self.precision_fractional = precision_fractional
        self.scale = base ** precision_fractional

    def encode(self, x, device: str | torch.device = "cuda") -> torch.Tensor:
        """float -> ring element round(x * scale) in two's complement, on
        ``device``."""
        v = np.round(np.asarray(x, dtype=np.float64) * self.scale).astype(np.int64)
        return to_ring(v, device)

    def decode(self, r: torch.Tensor) -> np.ndarray:
        """ring element -> float (host-side, exact int64 then divide)."""
        return from_ring_signed(r).astype(np.float64) / self.scale

    def truncate(self, r: torch.Tensor) -> torch.Tensor:
        """Rescale after a fixed-point multiply: signed divide by scale, on
        the tensor's device."""
        return ring_div_const_signed(r, self.scale)

    def __repr__(self) -> str:
        return (
            f"FixedPointEncoder(base={self.base}, "
            f"precision_fractional={self.precision_fractional})"
        )
