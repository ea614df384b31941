"""Device milliseconds a traced round spends in the held routed experts,
both directions: the ops launched inside ``pgt.moe.experts.fwd`` and
``pgt.moe.experts.bwd`` (``models/moe.py``'s ``_HeldExperts``, here at
top-8 of 128 with 8 held), by launch (``benchmark/round_spans.py``): the
rows' gathers, the grouped products, the SwiGLU and the weighted combine.
Reads nothing unless both are traced."""

from benchmark.round_spans import ms_per_round

LAYER = "expert layer"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    return ms_per_round(ctx, "pgt.moe.experts.fwd", "pgt.moe.experts.bwd")
