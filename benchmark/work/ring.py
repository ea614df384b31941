"""Least time of one Z_2^64 ring matmul: a frozen copy of ``chip_smoke.py``'s
``ring_bound()``. The product is counted as 36 u8 limb products at the int8
tensor-core rate against 8-byte operands read once and the output written
once, whatever kernel computes it."""

from benchmark.work.peaks import PEAK_BYTES, PEAK_INT8_OPS

RING_LIMB_PRODUCTS = 36


def ring_bound(B: int, M: int, K: int, N: int):
    """(bound ms, "operations" or "bytes", int8 ops, bytes) of a batch of
    ``B`` products ``[M, K] @ [K, N]``."""
    ops = RING_LIMB_PRODUCTS * 2 * B * M * N * K
    nbytes = 8 * B * (M * K + K * N + M * N)
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes", ops, nbytes
