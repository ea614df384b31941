"""Device milliseconds a traced round spends in the sliding-window
attention sublayers' forward: the ops launched inside ``pgt.attn.sliding``
(``models/afmoe.py``'s ``features``), by launch
(``benchmark/round_spans.py``): the input RMSNorm, the q, k, v and gate
projections, QK-norm, RoPE, the windowed grouped flash forward, the gate,
``W_o`` and the post-attention RMSNorm. The backward of these ops runs
under the autograd engine and is not in the span."""

from benchmark.round_spans import ms_per_round

LAYER = "attention"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    return ms_per_round(ctx, "pgt.attn.sliding")
