"""Profiling and timing utilities: the port's copy of
:mod:`pygrid_tpu.utils.profiling`.

The shared helpers: a sync-correct timer (the end of the device work, not
its enqueue, marks the end), a ``torch.profiler`` trace context that writes
a Chrome trace, and a process-wide stats registry the node's ``/status``
surface can report."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import torch

from pygrid_tpu_torch.device import resolve


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


def timed_call(name: str, fn: Callable, *args: Any, **kwargs: Any):
    """Run ``fn``, wait for its outputs, record; returns (result, seconds)."""
    with timed(name) as box:
        result = fn(*args, **kwargs)
        box["sync"] = result
    return result, box["seconds"]


@contextlib.contextmanager
def device_trace(log_dir: str, device: str | torch.device = "cuda") -> Iterator[Any]:
    """``torch.profiler`` trace of the block, host and (for a CUDA
    ``device``) card activity, written as a Chrome trace to
    ``log_dir/trace.json`` (open it in Perfetto). Yields the profiler."""
    dev = resolve(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
