"""Model FLOPs of one training round, fixed by the shapes.

For a decoder-only transformer: 6 · T · P_matmul for the forward and
backward of every weight matrix (the tied vocabulary head counted in P),
plus 6 · n_layers · T · L · d for causal attention (QK^T and PV, half the
L x L pairs live); nothing recomputed is counted. T is the round's token
count. For an MLP: 6 · samples · Σ n_in · n_out a gradient step.
"""


def transformer_matmul_params(vocab: int, d_model: int, d_ff: int, n_layers: int) -> int:
    """Parameters that enter a matrix product: q, k, v, o and the two MLP
    matrices of every layer, and the tied vocabulary head."""
    per_layer = 4 * d_model * d_model + 2 * d_model * d_ff
    return n_layers * per_layer + vocab * d_model


def transformer_round_flops(vocab: int, d_model: int, d_ff: int, n_layers: int,
                            tokens: int, seq_len: int) -> float:
    """FLOPs of one forward and backward over ``tokens`` tokens in
    sequences of ``seq_len``."""
    p = transformer_matmul_params(vocab, d_model, d_ff, n_layers)
    return 6.0 * tokens * p + 6.0 * n_layers * tokens * seq_len * d_model


def mlp_step_flops(sizes, samples: int) -> float:
    """FLOPs of one forward and backward of the MLP over ``samples`` rows."""
    return 6.0 * samples * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
