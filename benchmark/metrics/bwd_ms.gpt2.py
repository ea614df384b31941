"""Device milliseconds a traced round spends in its backward passes: the
ops launched inside ``pgt.round.backward`` (``parallel/fedavg_fused.py``'s
``_grad``, around ``torch.autograd.grad``) and, on the autograd engine's
thread, inside the spans it encloses, by launch (``benchmark/spans.py``)."""

from benchmark.spans import ms_per_unit

LAYER = "backward"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    return ms_per_unit(ctx, "pgt.round.backward")
