"""Device milliseconds a traced DeepSeek-V3 round spends in its backward
passes: the ops launched inside ``pgt.round.backward``
(``parallel/fedavg_fused.py``'s ``_grad``, around ``torch.autograd.grad``)
and, on the autograd engine's thread, inside the spans it encloses (flash's
and the held experts' backwards, the head's), by launch
(``benchmark/round_spans.py``)."""

from benchmark.round_spans import ms_per_round

LAYER = "backward"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    return ms_per_round(ctx, "pgt.round.backward")
