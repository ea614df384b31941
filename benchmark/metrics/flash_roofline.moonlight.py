"""The flash kernels' share of their roofline under multi-head latent
attention: Σ of each launch's bound (``work/mla_flash.py`` at this card's
``[rows, L, H, D_qk, D_v]``, bf16, causal: the true work, QKᵀ at D_qk and
PV at D_v, though the port pads v to D_qk) over Σ of the three kernels'
device time in the trace."""

from benchmark.work.flash import KERNELS
from benchmark.work.mla_flash import bounds

LAYER = "kernels"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    t, tr, cfg = ctx["trace"], ctx["traffic"], ctx["config"]["port"]
    if t is None:
        return None
    rows = tr["clients"] // ctx["chips"] * tr["batch"]
    shape = (rows, tr["seq_len"], cfg["n_heads"], cfg["qk_nope"] + cfg["qk_rope"], cfg["v_head"])
    b = bounds(shape, ctx["spec"].get("compute_dtype") or "float32", causal=True)
    bound_ms = busy_s = 0.0
    for name in KERNELS:
        ops = t.ops_matching(name)
        bound_ms += b[name][0] * len(ops)
        busy_s += sum(e - s for _, s, e in ops) / 1e6
    if busy_s == 0:
        return None
    return 100.0 * bound_ms / 1e3 / busy_s
