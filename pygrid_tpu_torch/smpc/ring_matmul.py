"""Exact matrix product over Z_2^64, with a hand-written Hopper kernel.

Counterpart of :mod:`pygrid_tpu.smpc.pallas_kernels` (``_matmul_kernel``,
entered through ``pallas_ring_matmul``): ``C = A·B mod 2^64`` on ring
tensors (int64, see :mod:`pygrid_tpu_torch.smpc.ring`). The CUDA kernel is
``csrc/ring_matmul.cu``; :func:`ring_matmul_reference` is its plain PyTorch
version. :func:`ring_matmul_kernel` runs the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.

Operands are ``[M, K] @ [K, N]``, batched ``[B, M, K] @ [B, K, N]`` (the
reference's vmap over pallas_call), or ``[B1, B2, M, K] @ [B1, B2, K, N]``
(a vmap of a vmap: a batch of rounds, each over the party axis). The
kernel reads every operand through its strides, so an operand broadcast
over a batch axis with ``expand`` (stride 0) is never copied.

torch has no int64 matmul on CUDA, so the plain version, which runs on
the CPU and on the card alike, is exact in float64: each operand splits into four 16-bit limbs, the ten limb products with
i + j < 4 run as float64 ``torch.matmul`` (exact while K·(2^16−1)² < 2^53,
so K is chunked at 2^21), and each goes back to int64 and folds in at bit
offset 16·(i + j) with wraparound — the reference's
``ring._ring_matmul_chunk`` with wider limbs.
"""

from __future__ import annotations

import torch

from pygrid_tpu_torch.kernels import build

#: launches of the kernel since the last :func:`reset_launch_counts`; the
#: wrapper adds one where it launches the kernel and nowhere else
launches = 0

#: K per exact float64 chunk: 2^21 · (2^16 − 1)² < 2^53
CHUNK_K = 1 << 21

_MASK16 = 0xFFFF


def launch_counts() -> dict[str, int]:
    return {"ring_matmul": launches}


def reset_launch_counts() -> None:
    global launches
    launches = 0


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    """The errors of ``pallas_ring_matmul``: a batch mismatch, operands of
    another rank (or of two ranks), a contraction mismatch; and here also
    a dtype other than int64 or two devices."""
    if a.dim() == b.dim() and a.dim() in (3, 4) and a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"batch mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dim() != b.dim() or a.dim() not in (2, 3, 4):
        raise ValueError("ring_matmul_kernel takes 2-D, 3-D or 4-D operands of one rank")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError(f"ring tensors are int64, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on two devices: {a.device} and {b.device}")


# --------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the yardstick on the card)
# --------------------------------------------------------------------------


def _limbs16(x: torch.Tensor) -> list[torch.Tensor]:
    """Four 16-bit limbs, little-endian, as float64 (masked after each
    arithmetic shift)."""
    return [((x >> (16 * i)) & _MASK16).to(torch.float64) for i in range(4)]


def _chunk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_l, b_l = _limbs16(a), _limbs16(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.int64, device=a.device)
    for i in range(4):
        for j in range(4 - i):  # offsets of 64 bits and more vanish mod 2^64
            p = torch.matmul(a_l[i], b_l[j]).to(torch.int64)  # exact, < 2^53
            acc += p << (16 * (i + j))
    return acc


def ring_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, exact and deterministic on
    the CPU and on the card."""
    _check(a, b)
    K = a.shape[-1]
    out = None
    for k0 in range(0, max(K, 1), CHUNK_K):
        part = _chunk(a[..., k0:k0 + CHUNK_K], b[..., k0:k0 + CHUNK_K, :])
        out = part if out is None else out + part
    return out


# --------------------------------------------------------------------------
# kernel wrapper
# --------------------------------------------------------------------------


def _as4d(x: torch.Tensor) -> torch.Tensor:
    """A view with two leading batch axes (size-1 axes added in front)."""
    while x.dim() < 4:
        x = x.unsqueeze(0)
    return x


def ring_matmul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b`` over Z_2^64 (int64 in, contiguous int64 out)."""
    _check(a, b)
    if a.device.type == "cpu":
        return ring_matmul_reference(a, b)
    global launches
    M, K, N = a.shape[-2], a.shape[-1], b.shape[-1]
    out = torch.empty(a.shape[:-1] + (N,), dtype=torch.int64, device=a.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    a4, b4, c4 = _as4d(a), _as4d(b), _as4d(out)
    B1, B2 = a4.shape[0], a4.shape[1]
    # a batch or M past the grid's limits comes back as a launch error
    build.launch(
        "ring_matmul", "pgt_ring_matmul", a.device,
        a4.data_ptr(), b4.data_ptr(), c4.data_ptr(), B1, B2, M, N, K,
        *a4.stride(), *b4.stride(), *c4.stride(),
    )
    launches += 1
    return out
