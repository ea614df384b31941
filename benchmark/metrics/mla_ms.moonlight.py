"""Device milliseconds a traced round spends in multi-head latent
attention's forward: the ops launched inside ``pgt.mla``
(``models/deepseek_v3.py``'s ``features``), by launch
(``benchmark/round_spans.py``): the projections, the norms, RoPE, v's padding and
the flash forward. The backward of these ops runs under the autograd
engine and is not in the span."""

from benchmark.round_spans import ms_per_round

LAYER = "attention"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    return ms_per_round(ctx, "pgt.mla")
