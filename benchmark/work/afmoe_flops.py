"""Model FLOPs of an AFMoE round on one card's expert share.

A round: 6 · T · P_matmul for the forward and backward of every weight
matrix, plus 12 · head_dim · n_heads FLOPs for each (query, key) pair that
attention keeps (QKᵀ and PV in the forward, twice that in the backward);
nothing recomputed is counted. P_matmul holds each layer's q, k, v, gate
and output projections (k and v at the n_kv_heads of grouped-query
attention), the dense MLPs, each expert layer's router and shared expert,
the held routed experts at the assignments a token is expected to give
them (top_k · held / n_experts, each one expert's three matrices), and the
head slice (the embedding is a lookup). T is the round's token count. A
sliding layer keeps ``band_pairs`` of a sequence's pairs, a full layer the
causal ``L (L + 1) / 2``.
"""


def band_pairs(L: int, window: int | None) -> int:
    """(query, key) pairs of one sequence of length ``L`` with
    ``0 <= i - j < window`` (None: every j <= i)."""
    if window is None or window >= L:
        return L * (L + 1) // 2
    return window * L - window * (window - 1) // 2


def matmul_params(c: dict) -> float:
    """P_matmul of a configuration's ``port`` block."""
    d, H, Hk, hd = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"]
    attn = 2 * d * H * hd + 2 * d * Hk * hd + H * hd * d
    first, end = c["experts_held"]
    per_token = c["top_k"] * (end - first) / c["n_experts"]
    dense = 3 * d * c["d_ff"]
    moe = (c["n_experts"] * d + 3 * d * c["n_shared"] * c["moe_ff"]
           + per_token * 3 * d * c["moe_ff"])
    n_moe = c["n_layers"] - c["n_dense"]
    return c["n_layers"] * attn + c["n_dense"] * dense + n_moe * moe + c["vocab"] * d


def attention_pairs(c: dict, seq_len: int) -> int:
    """Pairs one sequence keeps over every layer of the configuration."""
    return sum(band_pairs(seq_len, c["sliding_window"] if kind == "sliding_attention" else None)
               for kind in c["layer_types"])


def round_flops(c: dict, tokens: int, seq_len: int) -> float:
    """FLOPs of one forward and backward over ``tokens`` tokens in
    sequences of ``seq_len``."""
    attn = 12.0 * c["head_dim"] * c["n_heads"] * (tokens // seq_len) * attention_pairs(c, seq_len)
    return 6.0 * tokens * matmul_params(c) + attn
