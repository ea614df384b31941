"""Device milliseconds a traced round spends on the master update: the
ops launched inside ``pgt.round.update`` (``parallel/fedavg_fused.py``,
``p - lr · g`` over the f32 master params), by launch
(``benchmark/spans.py``)."""

from benchmark.spans import ms_per_unit

LAYER = "optimizer"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    return ms_per_unit(ctx, "pgt.round.update")
