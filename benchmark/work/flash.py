"""Least time of each flash-attention kernel's work on its inputs.

A frozen copy of ``chip_smoke.py``'s ``bounds()``: every input read once
and every output written once over the HBM rate, and the products that the
causal mask leaves live over the bf16 (or f32) peak, whichever is longer.
"""

from benchmark.work.peaks import PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS

PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_F32_FLOPS}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}
KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def causal_pairs(Lq: int, Lk: int, causal: bool) -> int:
    return Lq * (Lq + 1) // 2 if causal else Lq * Lk


def bounds(shape, dtype: str = "bfloat16", causal: bool = True) -> dict:
    """{kernel: (bound ms, "operations" or "bytes", flops, bytes)} for one
    launch at ``shape`` = (B, L, H, D)."""
    B, L, H, D = shape
    pairs = B * H * causal_pairs(L, L, causal)
    t = B * L * H * D * ELEMENT_BYTES[dtype]  # one [B, L, H, D] tensor
    row = B * H * L * 4  # one f32 [B*H, L] vector (lse or delta)
    work = {
        # S = QK^T, O = PV; reads q, k, v, writes o and lse
        "flash_fwd": (4 * D * pairs, 3 * t + t + row),
        # S^T, dP^T, dV = P^T dO, dK = dS^T Q; reads q, k, v, dO, lse,
        # delta, writes dK and dV
        "flash_bwd_dkv": (8 * D * pairs, 4 * t + 2 * row + 2 * t),
        # S, dP, dQ = dS K; reads q, k, v, dO, lse, delta, writes dQ
        "flash_bwd_dq": (6 * D * pairs, 4 * t + 2 * row + t),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        tf = flops / PEAK_FLOPS[dtype] * 1e3
        tb = nbytes / PEAK_BYTES * 1e3
        out[name] = (max(tf, tb), "operations" if tf > tb else "bytes", flops, nbytes)
    return out
