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

import math

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
    """Exact matmul over Z_2^64 with the reference's contraction: a's last
    axis with b's first, ``[..., M, K] @ [K, N, ...]`` -> ``[..., M, N, ...]``
    (1-D operands included). The CUDA kernel for tensors on the card, its
    plain version on the CPU (:mod:`pygrid_tpu_torch.smpc.ring_matmul`)."""
    return lead_matmul(a, b, 0)


def lead_matmul(a: torch.Tensor, b: torch.Tensor, n_lead: int) -> torch.Tensor:
    """:func:`ring_matmul` of each pair of slices along the first
    ``n_lead`` (≤ 2) axes, which ``a`` and ``b`` share: ``[L..., M..., K] @
    [L..., K, N...]`` -> ``[L..., M..., N...]``. a's M axes fold into one and
    b's N axes into one (a view where the strides allow), so every call is
    one launch of the batched kernel."""
    lead = tuple(a.shape[:n_lead])
    if a.dim() <= n_lead or b.dim() <= n_lead:
        raise TypeError(f"ring_matmul needs operands of rank ≥ 1: "
                        f"{tuple(a.shape)} @ {tuple(b.shape)}")
    K = a.shape[-1]
    if tuple(b.shape[:n_lead]) != lead or b.shape[n_lead] != K:
        raise TypeError(f"ring_matmul contracts a's last axis with b's first: "
                        f"{tuple(a.shape)} @ {tuple(b.shape)}")
    ms, ns = tuple(a.shape[n_lead:-1]), tuple(b.shape[n_lead + 1:])
    out = ring_matmul_kernel(a.reshape(lead + (math.prod(ms), K)),
                             b.reshape(lead + (K, math.prod(ns))))
    return out.reshape(lead + ms + ns)


def ring_matmul_np(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact matmul over Z_2^64 with ``np.matmul``'s semantics (where
    :func:`ring_matmul` has the reference's contraction): a 1-D ``a`` gains
    and loses a leading unit axis, a 1-D ``b`` a trailing one, and the
    batch axes in front of the last two broadcast. The broadcast batch axes
    are expanded (stride 0, not copied); more than two are folded into one.
    Every call is one launch of the kernel on the card. Raises ``ValueError``
    where ``np.matmul`` does."""
    if a.dim() == 0 or b.dim() == 0:
        raise ValueError(f"matmul: Input operand {0 if a.dim() == 0 else 1} does "
                         "not have enough dimensions")
    a2 = a.unsqueeze(0) if a.dim() == 1 else a
    b2 = b.unsqueeze(-1) if b.dim() == 1 else b
    if a2.shape[-1] != b2.shape[-2]:
        raise ValueError(f"matmul: Input operand 1 has a mismatch in its core dimension: "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    try:
        batch = tuple(torch.broadcast_shapes(a2.shape[:-2], b2.shape[:-2]))
    except RuntimeError as err:
        raise ValueError(f"operands could not be broadcast together: "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}") from err
    a3 = a2.expand(batch + tuple(a2.shape[-2:]))
    b3 = b2.expand(batch + tuple(b2.shape[-2:]))
    if len(batch) > 2:
        a3 = a3.reshape((math.prod(batch),) + tuple(a2.shape[-2:]))
        b3 = b3.reshape((math.prod(batch),) + tuple(b2.shape[-2:]))
    out = lead_matmul(a3, b3, 1 if len(batch) > 2 else len(batch))
    out = out.reshape(batch + tuple(out.shape[-2:]))
    if a.dim() == 1:
        out = out.squeeze(-2)
    if b.dim() == 1:
        out = out.squeeze(-1)
    return out


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


# --- collective ring sum (the mesh-sharded "open") ---------------------------


def ring_psum(r: torch.Tensor, mesh, axis: str, local_axis: int | None = 0) -> torch.Tensor:
    """Exact sum mod 2^64 over ``local_axis`` *and* the mesh axis ``axis``:
    the collective "open" of shares whose party axis is split over ``axis``.

    A collective's reduction of raw int64 words may overflow, and signed
    overflow is no guarantee there (NCCL reduces in C arithmetic, where it
    is undefined). So each element splits into four 16-bit limbs held in
    int64, as the reference's ``ring_psum`` splits its u32 halves: their
    sums stay below 2^63 for up to 2^47 parties, one all-reduce of the
    stacked limbs is exact, and the carries propagate once, locally,
    after it."""
    from pygrid_tpu_torch.parallel import collectives as C

    limbs = torch.stack([(r >> s) & _MASK16 for s in (0, 16, 32, 48)])
    if local_axis is not None:
        limbs = limbs.sum(dim=local_axis + 1)
    limbs = C.psum(limbs, mesh, axis)
    out, carry = torch.zeros_like(limbs[0]), None
    for i in range(4):
        c = limbs[i] if carry is None else limbs[i] + carry
        out |= (c & _MASK16) << (16 * i)
        carry = c >> 16
    return out
