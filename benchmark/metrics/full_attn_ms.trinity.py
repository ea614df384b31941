"""Device milliseconds a traced round spends in the full (NoPE) attention
sublayers' forward: the ops launched inside ``pgt.attn.full``
(``models/afmoe.py``'s ``features``), by launch
(``benchmark/round_spans.py``): the same as ``swa_ms.trinity`` reads on
the sliding layers, without RoPE, with the grouped flash forward over every
earlier key. The backward is not in the span."""

from benchmark.round_spans import ms_per_round

LAYER = "attention"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    return ms_per_round(ctx, "pgt.attn.full")
