"""Ring-2^64 arithmetic as one ``torch.int64`` tensor per value.

Counterpart of :mod:`pygrid_tpu.smpc.ring`. The TPU has no 64-bit integer
unit, so the reference carries each ring element as a ``Ring64`` pair of
uint32 limbs. Here a ring element is one int64 tensor whose two's-complement
bits are the value mod 2^64: torch wraps int64 add, sub, neg and mul (and
left shifts) on the CPU and on CUDA, so those ops are the plain operators.

Three int64 traps the ops below step around:

- ``>>`` on int64 is an arithmetic shift (it copies the sign bit), so every
  limb extraction masks after the shift;
- ``//`` floors signed values, while :func:`ring_div_const` is *unsigned*
  division over all 64 bits: it runs the reference's 16-bit-limb long
  division, whose intermediates stay non-negative and below 2^32;
- ``torch.randint`` cannot draw the full int64 range in one call (its
  ``high`` is exclusive and bounded), so :func:`ring_random` joins two
  32-bit draws.

Host conversion goes through numpy: ``torch.from_numpy`` takes no uint64,
so uint64 arrays cross as their int64 view.
"""

from __future__ import annotations

import numpy as np
import torch

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.smpc.ring_matmul import ring_matmul_kernel

_MASK16 = 0xFFFF


# --- host <-> ring conversion (numpy, exact via the int64 view) -------------


def to_ring(x, device: str | torch.device = "cuda") -> torch.Tensor:
    """Host integers (any int dtype, values taken mod 2^64) -> ring tensor."""
    v = np.asarray(x).astype(np.uint64).view(np.int64)
    return torch.from_numpy(v).to(resolve(device))


def from_ring(r: torch.Tensor) -> np.ndarray:
    """Ring tensor -> host uint64 (exact)."""
    return r.detach().cpu().numpy().copy().view(np.uint64)


def from_ring_signed(r: torch.Tensor) -> np.ndarray:
    """Ring tensor -> host int64, two's-complement interpretation (exact)."""
    return r.detach().cpu().numpy().copy()


def _signed(c: int) -> int:
    """A Python int mod 2^64 as the int64 with the same bits."""
    c %= 1 << 64
    return c - (1 << 64) if c >= 1 << 63 else c


# --- elementwise ring ops ---------------------------------------------------


def ring_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def ring_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b


def ring_neg(a: torch.Tensor) -> torch.Tensor:
    return -a


def ring_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise 64x64 -> low 64 bits."""
    return a * b


def ring_mul_const(a: torch.Tensor, c: int) -> torch.Tensor:
    return a * _signed(int(c))


def ring_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact matmul over Z_2^64, ``[..., M, K] @ [..., K, N]`` with up to
    two equal leading batch axes: the CUDA kernel for tensors on the card,
    its plain version on the CPU (:mod:`pygrid_tpu_torch.smpc.ring_matmul`)."""
    return ring_matmul_kernel(a, b)


# --- division by a small public constant (for fixed-point truncation) -------


def ring_div_const(a: torch.Tensor, d: int) -> torch.Tensor:
    """Exact unsigned division of each ring element by constant d < 2^16.

    16-bit-limb long division from the top limb down: the remainder stays
    < d < 2^16, so each step's dividend is below 2^32 and non-negative,
    where ``//`` is exact."""
    if not 0 < d < (1 << 16):
        raise ValueError("ring_div_const requires 0 < d < 2^16")
    rem = torch.zeros_like(a)
    q = torch.zeros_like(a)
    for shift in (48, 32, 16, 0):
        cur = (rem << 16) | ((a >> shift) & _MASK16)
        digit = cur // d
        rem = cur - digit * d
        q = (q << 16) | digit
    return q


def ring_div_const_signed(a: torch.Tensor, d: int) -> torch.Tensor:
    """Signed (two's-complement) division by a small constant, rounding
    toward zero like torch integer division in the reference stack."""
    neg = a < 0
    q = ring_div_const(torch.where(neg, -a, a), d)
    return torch.where(neg, -q, q)


# --- random ring elements ---------------------------------------------------


def ring_random(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform ring elements of ``shape`` on the generator's device: a
    signed 32-bit draw for the high half and an unsigned one for the low
    half, joined as hi·2^32 + lo, which covers [-2^63, 2^63) without
    overflow."""
    shape = tuple(shape)
    dev = generator.device
    hi = torch.randint(-(1 << 31), 1 << 31, shape, generator=generator,
                       dtype=torch.int64, device=dev)
    lo = torch.randint(0, 1 << 32, shape, generator=generator,
                       dtype=torch.int64, device=dev)
    return hi * (1 << 32) + lo
