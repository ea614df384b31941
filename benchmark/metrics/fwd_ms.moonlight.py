"""Device milliseconds a traced DeepSeek-V3 round spends in its forward
passes: the ops launched inside ``pgt.round.forward``
(``parallel/fedavg_fused.py``'s ``_grad``, around
``models/deepseek_v3.py``'s loss), by launch (``benchmark/round_spans.py``)."""

from benchmark.round_spans import ms_per_round

LAYER = "forward"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    return ms_per_round(ctx, "pgt.round.forward")
