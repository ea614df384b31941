"""Least time of each flash-attention kernel's work with a sliding window
and grouped K/V heads.

``work/flash.py``'s count at the pairs the band keeps: ``W · L − W (W −
1) / 2`` a (batch, head) slice with a window W < L, the causal ``L (L + 1)
/ 2`` without one. k and v (and dK, dV) hold ``H_kv`` heads: each is read
(or written) once at that width, as the kernels do, with no copy at the
query heads.
"""

from benchmark.work.afmoe_flops import band_pairs
from benchmark.work.flash import ELEMENT_BYTES, PEAK_FLOPS
from benchmark.work.peaks import PEAK_BYTES


def bounds(shape, window: int | None, dtype: str = "bfloat16") -> dict:
    """{kernel: (bound ms, "operations" or "bytes", flops, bytes)} for one
    causal launch at ``shape`` = (B, L, H, H_kv, D) with ``window``."""
    B, L, H, Hk, D = shape
    pairs = B * H * band_pairs(L, window)
    t = B * L * H * D * ELEMENT_BYTES[dtype]    # one tensor at the query heads
    tk = B * L * Hk * D * ELEMENT_BYTES[dtype]  # one at the K/V heads
    row = B * H * L * 4  # one f32 [B*H, L] vector (lse or delta)
    work = {
        # S = QKᵀ, O = PV; reads q, k, v, writes o and lse
        "flash_fwd": (4 * D * pairs, 2 * t + 2 * tk + row),
        # S, dP, dV = Pᵀ dO, dK = dSᵀ Q; reads q, dO, k, v, lse, delta,
        # writes dK and dV
        "flash_bwd_dkv": (8 * D * pairs, 2 * t + 4 * tk + 2 * row),
        # S, dP, dQ = dS K; reads q, dO, k, v, lse, delta, writes dQ
        "flash_bwd_dq": (6 * D * pairs, 3 * t + 2 * tk + 2 * row),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        tf = flops / PEAK_FLOPS[dtype] * 1e3
        tb = nbytes / PEAK_BYTES * 1e3
        out[name] = (max(tf, tb), "operations" if tf > tb else "bytes", flops, nbytes)
    return out
