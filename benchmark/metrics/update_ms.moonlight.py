"""Device milliseconds a traced DeepSeek-V3 round spends on the master
update: the ops launched inside ``pgt.round.update``
(``parallel/fedavg_fused.py``, ``p - lr · g`` over the f32 master params),
by launch (``benchmark/round_spans.py``)."""

from benchmark.round_spans import ms_per_round

LAYER = "optimizer"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    return ms_per_round(ctx, "pgt.round.update")
