"""Device milliseconds of NCCL kernels per round on rank 0 (the round's
``pmean_many`` in ``parallel/collectives.py``)."""

LAYER = "collectives"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    t = ctx["trace"]
    if t is None or not ctx["units"]:
        return None
    s = sum(e - b for n, b, e in t.device_ops if "nccl" in n.lower()) / 1e6
    return s * 1e3 / ctx["units"] if s > 0 else None
