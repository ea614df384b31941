"""The whole step's share of the cards' bf16 peak in an AFMoE round: the
round's model FLOPs (``work/afmoe_flops.py``: 6 · T · P_matmul with k and v
at the grouped K/V heads, the held experts at their expected assignments
and the head slice, plus attention at the pairs each layer's band keeps,
nothing recomputed) over seconds per traced round × cards × 989 TFLOP/s."""

from benchmark.work.peaks import PEAK_BF16_FLOPS

LAYER = "whole step"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    if not ctx.get("unit_s") or not ctx.get("round_flops"):
        return None
    return 100.0 * ctx["round_flops"] / (ctx["unit_s"] * ctx["chips"] * PEAK_BF16_FLOPS)
