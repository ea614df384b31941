"""Device milliseconds a traced round spends in its forward passes: the
ops launched inside ``pgt.round.forward`` (``parallel/fedavg_fused.py``'s
``_grad``, around the loss), by launch (``benchmark/spans.py``)."""

from benchmark.spans import ms_per_unit

LAYER = "forward"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    return ms_per_unit(ctx, "pgt.round.forward")
