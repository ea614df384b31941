"""Kernels launched per round by the round builder (``parallel/fedavg_fused.py``):
every CUDA kernel of the traced rounds over their count (copies and fills
left out)."""

LAYER = "round builder"
UNIT = "launches/round"
MOVES = "round_ms"


def read(ctx):
    t = ctx["trace"]
    if t is None or not ctx["units"] or not t.device_ops:
        return None
    return t.kernel_count / ctx["units"]
