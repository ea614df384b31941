"""The ring kernel's share of its roofline in an encrypted predict: Σ of the
bounds (``work/ring.py``) of its launches, 8 at ``[256,784]@[784,392]`` and
8 at ``[256,392]@[392,10]`` a predict, over Σ of its device time."""

from benchmark.work.ring import ring_bound

LAYER = "kernels"
UNIT = "%"
MOVES = "predict_ms_p95"


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    ops = t.ops_in_span("predict")
    ring = [op for op in ops if "ring_matmul" in op[0]]
    n = t.span_count("predict")
    sizes = ctx["config"]["sizes"]
    batch = ctx["traffic"]["batch"]
    per_predict = 8 * sum(ring_bound(1, batch, a, b)[0] for a, b in zip(sizes[:-1], sizes[1:]))
    if not ring or not n or len(ring) != 16 * n:
        return None
    busy_s = sum(e - s for _, s, e in ring) / 1e6
    return 100.0 * n * per_predict / 1e3 / busy_s
