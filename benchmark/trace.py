"""The traced run: torch.profiler over a bounded part of the window, reduced
in memory (no Chrome trace is written) to what the per-layer metrics read.

Spans are the benchmark's own ``record_function`` ranges named
``bench.<what>`` around each call into the program. The device's activity
is every kernel, copy and fill the profiler saw on this process's card.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

import torch

SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"


def span(name: str):
    """A host span of the benchmark's own, visible in the trace."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def profiled(enabled: bool):
    """torch.profiler over the block when ``enabled``; yields the profiler
    (None when off)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


@dataclass
class TraceData:
    """Device intervals (µs, the profiler's clock) inside the window, and
    the host's ops and spans there."""
    window: tuple
    device_ops: list = field(default_factory=list)   # (name, start, end)
    host_ops: list = field(default_factory=list)     # (thread, name, start, end)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def merged(self) -> list:
        """The union of the device intervals, clipped to the window."""
        w0, w1 = self.window
        out = []
        for _, s, e in sorted(self.device_ops, key=lambda x: x[1]):
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e6

    def ops_matching(self, *parts: str) -> list:
        """Device ops whose name holds any of ``parts``."""
        return [op for op in self.device_ops if any(p in op[0] for p in parts)]

    def ops_in_span(self, name: str) -> list:
        """Device ops that started while a host span ``bench.<name>`` was
        open (a span that ends in a synchronise holds all its work)."""
        spans = sorted((s, e) for _, n, s, e in self.host_ops if n == SPAN_PREFIX + name)
        out, j = [], 0
        for op in sorted(self.device_ops, key=lambda x: x[1]):
            while j < len(spans) and spans[j][1] < op[1]:
                j += 1
            if j < len(spans) and spans[j][0] <= op[1]:
                out.append(op)
        return out

    def span_count(self, name: str) -> int:
        return sum(1 for _, n, _, _ in self.host_ops if n == SPAN_PREFIX + name)

    @property
    def kernel_count(self) -> int:
        """Kernels launched (copies and fills left out)."""
        return sum(1 for n, _, _ in self.device_ops if not _is_copy(n))

    def idle_gaps(self) -> list:
        """(start, end) of each stretch of the window with nothing on the card."""
        w0, w1 = self.window
        gaps, t = [], w0
        for s, e in self.merged():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle time by what
        the host was doing: the innermost benchmark span and the innermost
        host op running at each gap's middle (the latest started one over
        all threads)."""
        by_op = defaultdict(float)
        for n, s, e in self.device_ops:
            by_op[n[:120]] += (e - s) / 1e6
        idle = defaultdict(float)
        for (g0, g1), (sp, op) in zip(self.idle_gaps(), self._host_at(self.idle_gaps())):
            idle[f"{sp} | {op}"] += (g1 - g0) / 1e6
        rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": rank(by_op), "idle_gaps": rank(idle)}

    def _host_at(self, gaps) -> list:
        points = [(g0 + g1) / 2 for g0, g1 in gaps]
        spans = [(s, e, n) for _, n, s, e in self.host_ops if n.startswith(SPAN_PREFIX)
                 and n != WINDOW_SPAN]
        ops = [(s, e, n) for _, n, s, e in self.host_ops if not n.startswith(SPAN_PREFIX)]
        return list(zip(_innermost(spans, points, "no span"), _innermost(ops, points, "host, no op")))


def _innermost(intervals, points, none: str) -> list:
    """For each point, the name of the latest started interval holding it."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    ivs = sorted(intervals)
    out = [none] * len(points)
    open_, j = [], 0
    for i in order:
        p = points[i]
        while j < len(ivs) and ivs[j][0] <= p:
            open_.append(ivs[j])
            j += 1
        open_ = [iv for iv in open_ if iv[1] >= p]
        if open_:
            out[i] = max(open_, key=lambda iv: iv[0])[2]
    return out


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def reduce(prof, device_index: int | None = None) -> TraceData:
    """The window's device and host activity from a finished profiler."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = None
    device_ops, host_ops = [], []
    for ev in events:
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            # a span's range on the device's timeline is no device work
            if getattr(ev, "is_user_annotation", False) or ev.name.startswith(SPAN_PREFIX):
                continue
            if device_index is None or ev.device_index == device_index:
                device_ops.append((ev.name, tr.start, tr.end))
        elif ev.device_type == DeviceType.CPU:
            if ev.name == WINDOW_SPAN:
                window = (tr.start, tr.end)
            host_ops.append((ev.thread, ev.name, tr.start, tr.end))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    keep = lambda s, e: e > w0 and s < w1  # noqa: E731
    return TraceData(window=window,
                     device_ops=[op for op in device_ops if keep(op[1], op[2])],
                     host_ops=[op for op in host_ops if keep(op[2], op[3])])
