"""The flash kernels' share of their roofline with a sliding window and
grouped K/V heads: Σ of each launch's bound (``work/window_flash.py`` at
this card's ``[rows, L, H, H_kv, D]``, bf16, causal, the band's pairs on a
sliding layer and the causal pairs on a full one) over Σ of the three
kernels' device time in the trace. A round launches each kernel once a
layer (the forward again in a recompute), in the configuration's mix of
sliding and full layers, so the launches of a kernel are told apart by
count: each takes the mean bound over the layers."""

from benchmark.work.flash import KERNELS
from benchmark.work.window_flash import bounds

LAYER = "kernels"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    t, tr, cfg = ctx["trace"], ctx["traffic"], ctx["config"]["port"]
    if t is None:
        return None
    rows = tr["clients"] // ctx["chips"] * tr["batch"]
    shape = (rows, tr["seq_len"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"])
    dtype = ctx["spec"].get("compute_dtype") or "float32"
    per_kind = {kind: bounds(shape, cfg["sliding_window"] if kind == "sliding_attention"
                             else None, dtype) for kind in set(cfg["layer_types"])}
    kinds = cfg["layer_types"]
    bound_ms = busy_s = 0.0
    for name in KERNELS:
        ops = t.ops_matching(name)
        mean = sum(per_kind[kind][name][0] for kind in kinds) / len(kinds)
        bound_ms += mean * len(ops)
        busy_s += sum(e - s for _, s, e in ops) / 1e6
    if busy_s == 0:
        return None
    return 100.0 * bound_ms / 1e3 / busy_s
