"""Model FLOPs of a DeepSeek-V3 round on one card's expert share, and the
work of each grouped product of its held experts.

A round: 6 · T · P_matmul for the forward and backward of every weight
matrix, plus 6 · n_layers · T · L · H · (D_qk + D_v) / 2 for causal
attention (QKᵀ at D_qk, PV at D_v, half the L × L pairs live); nothing
recomputed is counted. P_matmul holds the attention's four matrices, the
dense MLP, each expert layer's router and shared experts, the held routed
experts at the assignments a token is expected to give them
(top_k · held / n_experts, each one expert's three matrices), and the head
slice (the embedding is a lookup). T is the round's token count.
"""

from benchmark.work.peaks import PEAK_BF16_FLOPS, PEAK_BYTES


def matmul_params(c: dict) -> float:
    """P_matmul of a configuration's ``port`` block."""
    d, H = c["d_model"], c["n_heads"]
    dqk = c["qk_nope"] + c["qk_rope"]
    attn = (d * H * dqk + d * (c["kv_lora"] + c["qk_rope"])
            + c["kv_lora"] * H * (c["qk_nope"] + c["v_head"]) + H * c["v_head"] * d)
    dense = attn + 3 * d * c["d_ff"]
    first, end = c["experts_held"]
    per_token = c["top_k"] * (end - first) / c["n_experts"]
    moe = (attn + c["n_experts"] * d + 3 * d * c["n_shared"] * c["moe_ff"]
           + per_token * 3 * d * c["moe_ff"])
    n_moe = c["n_layers"] - c["n_dense"]
    return c["n_dense"] * dense + n_moe * moe + c["vocab"] * d


def round_flops(c: dict, tokens: int, seq_len: int) -> float:
    """FLOPs of one forward and backward over ``tokens`` tokens in
    sequences of ``seq_len``."""
    attn = (6.0 * c["n_layers"] * tokens * seq_len * c["n_heads"]
            * (c["qk_nope"] + c["qk_rope"] + c["v_head"]) / 2)
    return 6.0 * tokens * matmul_params(c) + attn


def expert_launches(n: float, d: int, f: int, held: int) -> dict:
    """{launch: (bound s, flops, bytes)} of the eight grouped bf16
    products one expert layer runs in a round over ``n`` held assignments:
    ``fwd`` (gate‖up, down) in the forward, and ``bwd`` (the two again,
    then the down's input gradient, the gate‖up's input gradient, and both
    weights' gradients) in the backward. Each operand is read once and each
    output written once; the weights of all ``held`` experts count."""
    el = 2
    w_gu, w_dn = held * d * 2 * f, held * f * d
    gemms = {
        "gu": (2 * n * d * 2 * f, n * d + w_gu + n * 2 * f),
        "down": (2 * n * f * d, n * f + w_dn + n * d),
        "d_a": (2 * n * d * f, n * d + w_dn + n * f),
        "d_x": (2 * n * 2 * f * d, n * 2 * f + w_gu + n * d),
        "d_wdown": (2 * n * f * d, n * f + n * d + w_dn),
        "d_wgu": (2 * n * d * 2 * f, n * d + n * 2 * f + w_gu),
    }
    out = {}
    for name, (flops, elems) in gemms.items():
        nbytes = elems * el
        out[name] = (max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES), flops, nbytes)
    return out


#: the launches of one expert layer's forward, and of its backward, in the
#: order ``models/moe.py``'s ``_HeldExperts`` makes them
FWD = ("gu", "down")
BWD = ("gu", "down", "d_a", "d_wdown", "d_wgu", "d_x")
