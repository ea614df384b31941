"""Profiling and timing utilities: the port's copy of
:mod:`pygrid_tpu.utils.profiling`.

The shared helpers: a sync-correct timer (the end of the device work, not
its enqueue, marks the end), a process-wide stats registry the node's
``/status`` surface can report, and :func:`region`, a named range of the
program on ``torch.profiler``'s clock."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, ContextManager, Iterator

import torch


@dataclass
class TimingStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def record(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self.min_s = min(self.min_s, seconds)
        self.max_s = max(self.max_s, seconds)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "total_s": round(self.total_s, 6),
            "mean_s": round(self.mean_s, 6),
            "min_s": round(self.min_s, 6) if self.count else None,
            "max_s": round(self.max_s, 6),
        }


class _Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats: dict[str, TimingStats] = defaultdict(TimingStats)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._stats[name].record(seconds)

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {k: v.to_dict() for k, v in sorted(self._stats.items())}

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


#: process-wide registry (exposed through the node /status route)
stats = _Registry()


def _cuda_devices(target: Any) -> set[torch.device]:
    """The CUDA devices holding the tensors of ``target`` (a tensor, or
    lists, tuples and dicts of them)."""
    if isinstance(target, torch.Tensor):
        return {target.device} if target.is_cuda else set()
    if isinstance(target, dict):
        target = list(target.values())
    if isinstance(target, (list, tuple)):
        found: set[torch.device] = set()
        for item in target:
            found |= _cuda_devices(item)
        return found
    return set()


def _sync(target: Any) -> None:
    """Wait for the device work that produces ``target``: a synchronise
    of each CUDA device holding one of its tensors (PyTorch returns before
    the card finishes)."""
    for dev in _cuda_devices(target):
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timed(name: str, sync: Any = None) -> Iterator[dict]:
    """Wall-clock a block; with ``sync`` (a tensor or a list, tuple or
    dict of them; or ``box["sync"]`` set inside the block), end the timing
    only after the device work producing it is done."""
    t0 = time.monotonic()
    box = {"seconds": None}
    try:
        yield box
    finally:
        target = box.get("sync", sync)
        if target is not None:
            _sync(target)
        box["seconds"] = time.monotonic() - t0
        stats.record(name, box["seconds"])


_NO_REGION = contextlib.nullcontext()


def region(name: str) -> ContextManager:
    """A named range of the program in a ``torch.profiler`` trace, for the
    block: ``record_function(name)`` while the profiler records on this
    thread (the autograd engine's threads inherit that from the caller of
    the backward), else a shared no-op context. Off, it costs one check:
    no allocation, no ids, no bus event."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_REGION
