"""The held experts' grouped products' share of their roofline: Σ of each
product launch's bound over the launches' device time.

A product launch is the kernel launched right after each of PyTorch's
``prepare_grouped_gemm_data`` kernels (one pair a ``grouped_mm`` call),
inside ``pgt.moe.experts.fwd`` or ``pgt.moe.experts.bwd``
(``models/moe.py``'s ``_HeldExperts``), each op paired with its launch
call by stream order over the window's whole rounds
(``benchmark/round_spans.py``). Its bound is
``work/moe_flops.py``'s for its place in the span's sequence of products,
at the held assignments a call routed on average over the run, from the
program's counter (``models/moe.py:moe_counts``): max(FLOP / 989 TFLOP/s,
bytes / 3.35 TB/s). Reads nothing where the program has no such counter
or the trace no such launch."""

from benchmark.round_spans import paired_ops
from benchmark.work.moe_flops import BWD, FWD, expert_launches

LAYER = "expert layer"
UNIT = "%"
MOVES = "train_tokens_per_s"

SPANS = {"pgt.moe.experts.fwd": FWD, "pgt.moe.experts.bwd": BWD}


def _mean_assignments():
    try:
        from pygrid_tpu_torch.models import moe
    except ImportError:
        return None
    counts = getattr(moe, "moe_counts", lambda: None)()
    if not counts or not counts["calls"]:
        return None
    return counts["held_assignments"] / counts["calls"]


def _product_launches(t):
    """(span name, device seconds) of each product launch, in launch order,
    over the window's whole rounds."""
    got = paired_ops(t)
    if got is None:
        return []
    ops = got[0]
    spans = [sp for sp in t.host_ops if sp[1] in SPANS]
    out = []
    for i, (name, _, _, _) in enumerate(ops[:-1]):
        if "prepare_grouped_gemm_data" not in name:
            continue
        _, seconds, thread, launched = ops[i + 1]
        open_ = [sp for sp in spans if sp[2] <= launched <= sp[3]]
        mine = [sp for sp in open_ if sp[0] == thread] or open_
        if mine:
            out.append((max(mine, key=lambda sp: sp[2])[1], seconds))
    return out


def read(ctx):
    t, cfg = ctx["trace"], ctx["config"]["port"]
    if t is None:
        return None
    n = _mean_assignments()
    launches = _product_launches(t)
    if n is None or not launches:
        return None
    first, end = cfg["experts_held"]
    work = expert_launches(n, cfg["d_model"], cfg["moe_ff"], end - first)
    seen = {name: 0 for name in SPANS}
    bound_s = busy_s = 0.0
    for span, seconds in launches:
        order = SPANS[span]
        bound_s += work[order[seen[span] % len(order)]][0]
        seen[span] += 1
        busy_s += seconds
    return 100.0 * bound_s / busy_s
