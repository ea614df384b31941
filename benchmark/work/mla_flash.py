"""Least time of each flash-attention kernel's work under multi-head latent
attention, where the values are narrower than the queries and keys.

``work/flash.py``'s count at two head widths: S = QKᵀ and every product
with Q or K at D_qk, every product with V or dO at D_v; every input read
once and every output written once at its own width. The port pads V to
D_qk for the kernels, which take one D: the columns of zeros are no work,
so the padding shows as lost roofline.
"""

from benchmark.work.flash import ELEMENT_BYTES, PEAK_FLOPS, causal_pairs
from benchmark.work.peaks import PEAK_BYTES


def bounds(shape, dtype: str = "bfloat16", causal: bool = True) -> dict:
    """{kernel: (bound ms, "operations" or "bytes", flops, bytes)} for one
    launch at ``shape`` = (B, L, H, D_qk, D_v)."""
    B, L, H, dqk, dv = shape
    pairs = B * H * causal_pairs(L, L, causal)
    tq = B * L * H * dqk * ELEMENT_BYTES[dtype]  # one [B, L, H, D_qk] tensor
    tv = B * L * H * dv * ELEMENT_BYTES[dtype]   # one [B, L, H, D_v] tensor
    row = B * H * L * 4
    work = {
        # S = QKᵀ, O = PV; reads q, k, v, writes o and lse
        "flash_fwd": (2 * (dqk + dv) * pairs, 2 * tq + tv + tv + row),
        # S, dP = dO Vᵀ, dV = Pᵀ dO, dK = dSᵀ Q; reads q, k, v, dO, lse,
        # delta, writes dK and dV
        "flash_bwd_dkv": (4 * (dqk + dv) * pairs, 2 * tq + 2 * tv + 2 * row + tq + tv),
        # S, dP, dQ = dS K; reads q, k, v, dO, lse, delta, writes dQ
        "flash_bwd_dq": ((4 * dqk + 2 * dv) * pairs, 2 * tq + 2 * tv + 2 * row + tq),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        tf = flops / PEAK_FLOPS[dtype] * 1e3
        tb = nbytes / PEAK_BYTES * 1e3
        out[name] = (max(tf, tb), "operations" if tf > tb else "bytes", flops, nbytes)
    return out
