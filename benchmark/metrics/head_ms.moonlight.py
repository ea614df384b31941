"""Device milliseconds a traced DeepSeek-V3 round spends in its untied CE
head, both directions: the ops launched inside ``pgt.model.head.fwd`` and
``pgt.model.head.bwd`` (``models/transformer.py``'s ``_CEHead`` over the
head slice), by launch (``benchmark/round_spans.py``). Reads nothing unless both
are traced."""

from benchmark.round_spans import ms_per_round

LAYER = "CE head"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    return ms_per_round(ctx, "pgt.model.head.fwd", "pgt.model.head.bwd")
