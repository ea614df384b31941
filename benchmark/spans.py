"""Device time of the program's own spans, by the launch of each device op.

The port names the parts of its round with ``pgt.<what>`` ranges
(``pygrid_tpu_torch/utils/profiling.py:region``): ``record_function``
ranges while a profiler records, on the thread that runs them. A device
op belongs to the launch call that enqueued it, and from there to the
innermost ``pgt.`` span open around that call on the launching thread. A
launch on a thread with no ``pgt.`` span open (the autograd engine's
thread outside the model's spans) falls back to the innermost ``pgt.``
span open on any thread then: the caller's ``pgt.round.backward``. The op
counts for that span and for every ``pgt.`` span enclosing it. Attribution
by when an op ran would hand it to whatever span the host, running ahead
of the card, had open by then.

The reduced trace (``trace.TraceData``) keeps no correlation ids, so each
op's launch is found by stream order: on one stream the card runs ops in
the order they were enqueued, so the i-th device op of the window is the
i-th launch call of the window. Where the counts differ, or a pair's
kinds do (a copy, a fill or a kernel), the pairing does not hold and
nothing is read. Times do not check it: the card's clock, mapped onto the
host's, can put an op that ran on an idle card a few microseconds before
its call. On an H100 the pairing matched the profiler's own correlation
ids on every op of a process's first profiler session; later sessions in
one process lose device records (CUPTI), so a run profiles once.

So the metrics that read this hold only for a trace of one stream and no
graph launches: a ``cudaGraphLaunch`` enqueues many ops from one call, and
a second stream (an overlapped all-reduce, a prefetch) interleaves its ops
with the first's. The first makes the counts differ and the metrics read
nothing; the second can pair each op with another stream's launch while
every op still starts after its call, and then nothing here notices.
"""

from __future__ import annotations

from collections import defaultdict

PREFIX = "pgt."
#: host calls that enqueue one device op each, by the kind of op: kernel
#: launches, copies (``Memcpy ...`` on the card) and fills (``Memset ...``)
LAUNCH_CALLS = {"cudaLaunch": "kernel", "cuLaunch": "kernel", "cudaMemcpy": "Memcpy",
                "cuMemcpy": "Memcpy", "cudaMemset": "Memset", "cuMemset": "Memset"}


def _call_kind(name: str) -> str | None:
    return next((kind for call, kind in LAUNCH_CALLS.items() if name.startswith(call)), None)


def _op_kind(name: str) -> str:
    return name[:6] if name.startswith(("Memcpy", "Memset")) else "kernel"


def attribute(ops, spans) -> dict:
    """``{span name: (device seconds, count)}``: each op's seconds counted
    once for each name among its span and the spans enclosing it; the
    count is how many spans of that name there were.

    ``ops``: ``(seconds, launching thread, launch time)`` of each device op.
    ``spans``: ``(thread, name, start, end)`` of the program's spans. Times
    on one clock, in any unit; an op launched outside every span counts
    for none."""
    by_start = sorted(spans, key=lambda sp: sp[2])
    seconds = defaultdict(float)
    count = defaultdict(int)
    for sp in spans:
        count[sp[1]] += 1
    open_, j = [], 0
    for dur, thread, t in sorted(ops, key=lambda op: op[2]):
        while j < len(by_start) and by_start[j][2] <= t:
            open_.append(by_start[j])
            j += 1
        open_ = [sp for sp in open_ if sp[3] >= t]
        if not open_:
            continue
        mine = [sp for sp in open_ if sp[0] == thread] or open_
        inner = max(mine, key=lambda sp: (sp[2], -sp[3]))  # latest started, then shortest
        for name in {sp[1] for sp in open_ if sp[2] <= inner[2] and sp[3] >= inner[3]}:
            seconds[name] += dur
    return {name: (seconds[name], n) for name, n in count.items()}


def launched_ops(trace) -> list | None:
    """``(seconds, thread, launch time)`` of each device op of a reduced
    trace, paired with the window's launch calls by stream order; None
    where they do not pair."""
    calls = sorted((s, th, _call_kind(name)) for th, name, s, _ in trace.host_ops
                   if _call_kind(name))
    ops = sorted(trace.device_ops, key=lambda op: op[1])
    if not ops or len(calls) != len(ops):
        return None
    if any(_op_kind(op[0]) != kind for op, (_, _, kind) in zip(ops, calls)):
        return None
    return [((e - s) / 1e6, th, t) for (_, s, e), (t, th, _) in zip(ops, calls)]


def ms_per_unit(ctx, *names: str) -> float | None:
    """Device ms a traced unit attributed to the spans ``names`` together
    (each op once per name); None where any of them was not traced, or the
    trace's ops do not pair with their launches."""
    t = ctx["trace"]
    if t is None or not ctx.get("units"):
        return None
    spans = [op for op in t.host_ops if op[1].startswith(PREFIX)]
    ops = launched_ops(t) if spans else None
    if ops is None:
        return None
    got = attribute(ops, spans)
    if not all(n in got for n in names):
        return None
    return sum(got[n][0] for n in names) * 1e3 / ctx["units"]
