"""Device milliseconds a traced round spends in the tied CE head, both
directions: the ops launched inside ``pgt.model.head.fwd`` and
``pgt.model.head.bwd`` (``models/transformer.py``'s ``_CEHead``), by
launch (``benchmark/spans.py``). It reads nothing unless both are traced:
a head that is not ``_CEHead`` (the plain path, ``ce_chunk``) opens
neither, and without its backward span it would count one direction."""

from benchmark.spans import ms_per_unit

LAYER = "CE head"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    return ms_per_unit(ctx, "pgt.model.head.fwd", "pgt.model.head.bwd")
