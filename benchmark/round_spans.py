"""Device time of the program's ``pgt.`` spans over a traced window's whole
rounds.

``spans.py`` pairs the i-th device op of the window with its i-th launch
call, and reads nothing where the counts differ. The card's clock, mapped
onto the host's, can put the window's last few ops past the window's end,
where ``trace.reduce`` drops them: on an H100, one traced DeepSeek-V3 window
of six rounds (27,474 launches) kept all but its last 13 ops, and every
span metric read by ``spans.py`` fell silent. Here the window's launch calls
are cut into its ``bench.round`` spans (a round's calls run from its start
to the next round's), and the pairing, still by stream order from the
window's first op, covers the rounds whose ops all came: the leading rounds
that hold no more calls than there are ops. A round that lost an op is left
out, and the time is averaged over the rounds kept. The window's start
holds milliseconds of the profiler's own set-up before its first launch, so
no op is lost there. The rest holds as in ``spans.py``: one stream, no graph
launches.
"""

from __future__ import annotations

from bisect import bisect_left

from benchmark import spans as S
from benchmark.trace import SPAN_PREFIX

ROUND = SPAN_PREFIX + "round"


def paired_ops(trace):
    """``([(name, seconds, thread, launch time)], rounds)``: the device ops
    of the window's leading whole rounds, each with its launch call, and
    how many rounds they are; None where no round pairs, the window holds
    more ops than launches, or a pair's kinds differ. A trace with no
    ``bench.round`` span is one round."""
    calls = sorted((s, th, S._call_kind(name)) for th, name, s, _ in trace.host_ops
                   if S._call_kind(name))
    ops = sorted(trace.device_ops, key=lambda op: op[1])
    if not ops or len(ops) > len(calls):
        return None
    starts = sorted(s for _, name, s, _ in trace.host_ops if name == ROUND)
    at = [c[0] for c in calls]
    ends = [bisect_left(at, s) for s in starts[1:]] + [len(calls)]
    whole = [n for n in ends if n <= len(ops)]
    if not whole or not whole[-1]:
        return None
    n = whole[-1]
    if any(S._op_kind(op[0]) != kind for op, (_, _, kind) in zip(ops[:n], calls[:n])):
        return None
    return ([(name, (e - s) / 1e6, th, t) for (name, s, e), (t, th, _) in zip(ops[:n], calls[:n])],
            len(whole))


def ms_per_round(ctx, *names: str) -> float | None:
    """Device ms a traced round attributed to the spans ``names`` together
    (each op once per name), over the whole rounds ``paired_ops`` keeps;
    None where any of them was not traced or nothing pairs."""
    t = ctx["trace"]
    if t is None:
        return None
    spans = [op for op in t.host_ops if op[1].startswith(S.PREFIX)]
    got = paired_ops(t) if spans else None
    if got is None:
        return None
    ops, rounds = got
    attributed = S.attribute([(sec, th, at) for _, sec, th, at in ops], spans)
    if not all(n in attributed for n in names):
        return None
    return sum(attributed[n][0] for n in names) * 1e3 / rounds
