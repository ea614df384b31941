"""Per-program profiling and device-memory sampling.

The port's counterpart of :mod:`pygrid_tpu.telemetry.profiler`, feeding
the same bus families (``profiler_compile_seconds``,
``profiler_execute_seconds``) and ``GET /telemetry/programs`` rows:

1. **Where did a serving regression come from** — build, launch, or host
   time? The profiler wraps every program the serving
   :class:`~pygrid_tpu_torch.serving.programs.ProgramSet` builds and
   splits wall-clock per call into *compile* and *execute*, per program
   key. A port program is eager PyTorch built once per bucket: a call
   counts as a compile when it grew the program's signature cache (its
   ``_cache_size`` hook — the first call, build plus first launch, or a
   call with new argument shapes), as a hit otherwise. The wrapper never
   touches the arguments (the engine's KV pools are updated in place),
   only the clock. **Execute semantics**: the clock stops when the call
   returns, without a device sync — on CUDA that is the time to launch
   the program's kernels, a lower bound on its device time, just as
   JAX's async dispatch gives the reference; the engine's
   ``serving_token_seconds`` histogram includes the token fetch.
2. **Is device memory drifting** — a background sampler reads
   ``torch.cuda.memory_stats()`` and ``torch.cuda.mem_get_info()`` for
   every visible card on a cadence and serves the latest gauges to
   ``/metrics`` (without a GPU the gauges are simply absent).

``PYGRID_PROFILER=off`` makes ``wrap()`` return the function unchanged
and the sampler never start. The opt-in cost attribution
(``PYGRID_PROFILER_COST``) counts a program's FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` on meta tensors of its first
call's arguments, and its bytes as those arguments' and outputs' sizes.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable

from pygrid_tpu_torch.telemetry import bus

#: device-memory sampling cadence, seconds (env-overridable)
DEFAULT_SAMPLE_INTERVAL_S = 10.0


def enabled() -> bool:
    """The profiler off-switch: on by default, disabled with
    ``PYGRID_PROFILER=off|0``."""
    return os.environ.get("PYGRID_PROFILER", "").lower() not in ("off", "0")


def cost_enabled() -> bool:
    """Cost attribution off-switch (``PYGRID_PROFILER_COST=off``): the
    analysis replays each program once on meta tensors — no device work,
    but host work an operator may not want on a loaded node."""
    return enabled() and os.environ.get(
        "PYGRID_PROFILER_COST", ""
    ).lower() not in ("off", "0")


def _tree_map(fn, obj):
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_map(fn, o) for o in obj)
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    return fn(obj)


def _nbytes(obj) -> int:
    import torch

    total = 0

    def add(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        return x

    _tree_map(add, obj)
    return total


class JitSiteProfiler:
    """Registry of program callsites and their timing splits.

    One entry per ``(model, kind, bucket)`` program — the identity the
    serving ``ProgramSet`` builds under. ``wrap()`` is the only producer.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._programs: dict[tuple, dict] = {}
        #: program key -> (fn, meta-tensor args) captured at first call
        #: for lazy cost attribution; meta tensors carry shape and dtype
        #: only, never the buffers
        self._cost_src: dict[tuple, tuple] = {}
        self._cost: dict[tuple, dict | None] = {}

    def wrap(
        self,
        fn: Callable,
        kind: str,
        bucket: int,
        model_id: str = "",
    ) -> Callable:
        """Time every call of ``fn``; classify as compile when the call
        grew ``fn._cache_size()`` (or, without the hook, when it is the
        first call), execute otherwise. Returns ``fn`` unchanged when
        the profiler is disabled."""
        if not enabled():
            return fn
        key = (model_id, kind, int(bucket))
        with self._lock:
            entry = self._programs.setdefault(
                key,
                {
                    "model": model_id,
                    "kind": kind,
                    "bucket": int(bucket),
                    "compiles": 0,
                    "compile_s": 0.0,
                    "hits": 0,
                    "execute_s": 0.0,
                    "traces": 0,
                },
            )
        cache_size = getattr(fn, "_cache_size", None)
        # per-WRAPPER watermark: a re-hosted model rebuilds its programs
        # under the same key, and their first calls are compiles again
        seen = {"traces": 0, "calls": 0}

        def wrapped(*args: Any, **kwargs: Any):
            if seen["calls"] == 0:
                # shapes BEFORE the first call: the call updates the
                # KV pools in place
                self._capture_avals(key, fn, args, kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            traces = cache_size() if callable(cache_size) else None
            with self._lock:
                if traces is not None:
                    compiled = traces > seen["traces"]
                    seen["traces"] = max(seen["traces"], traces)
                else:
                    compiled = seen["calls"] == 0
                seen["calls"] += 1
                if compiled:
                    entry["compiles"] += 1
                    entry["compile_s"] += dt
                    entry["traces"] += 1
                else:
                    entry["hits"] += 1
                    entry["execute_s"] += dt
            if compiled:
                bus.observe("profiler_compile_seconds", dt, kind=kind)
            else:
                bus.observe("profiler_execute_seconds", dt, kind=kind)
            return out

        if callable(cache_size):
            wrapped._cache_size = cache_size  # keep trace_count() honest
        wrapped.__wrapped__ = fn
        return wrapped

    def _capture_avals(self, key: tuple, fn, args, kwargs) -> None:
        """Meta-tensor skeleton of a program's first-call arguments —
        enough to replay it later for cost attribution without holding
        the real buffers."""
        if not cost_enabled():
            return
        try:
            import torch

            def _meta(a):
                if isinstance(a, torch.Tensor):
                    return torch.empty(a.shape, dtype=a.dtype, device="meta")
                return a

            avals = (_tree_map(_meta, args), _tree_map(_meta, kwargs))
        except Exception:  # noqa: BLE001 — attribution is best-effort
            return
        with self._lock:
            self._cost_src.setdefault(key, (fn, avals))

    def _cost_for(self, key: tuple) -> dict | None:
        """Lazy per-program cost (FLOPs and bytes), computed once from the
        captured meta arguments by replaying the program under
        ``FlopCounterMode`` and cached. The bytes are the arguments' and
        the outputs' sizes: what the program must at least move. None
        when unavailable."""
        with self._lock:
            if key in self._cost:
                return self._cost[key]
            src = self._cost_src.get(key)
        if src is None or not cost_enabled():
            return None
        result: dict | None = None
        try:
            from torch.utils.flop_counter import FlopCounterMode

            fn, (args, kwargs) = src
            fn = getattr(fn, "__wrapped__", fn)
            counter = FlopCounterMode(display=False)
            with counter:
                out = fn(*args, **kwargs)
            result = {
                "flops": float(counter.get_total_flops()),
                "bytes_accessed": float(_nbytes((args, kwargs)) + _nbytes(out)),
            }
        except Exception:  # noqa: BLE001 — attribution is best-effort
            result = None
        with self._lock:
            self._cost[key] = result
        return result

    def snapshot(self, include_cost: bool = False) -> list[dict]:
        """Per-program rows for ``GET /telemetry/programs``: program key,
        bucket, compile ms, hit count, execute-time split — plus, with
        ``include_cost``, FLOPs and bytes per call and over the call
        count, rows ranked by total bytes."""
        with self._lock:
            rows = [
                (key, dict(e)) for key, e in self._programs.items()
            ]
        out = []
        for key, e in rows:
            hits = e["hits"]
            row = {
                "program": f"{e['kind']}/{e['bucket']}",
                "model": e["model"],
                "kind": e["kind"],
                "bucket": e["bucket"],
                "compiles": e["compiles"],
                "compile_ms": round(e["compile_s"] * 1e3, 3),
                "hits": hits,
                "execute_ms_total": round(e["execute_s"] * 1e3, 3),
                "execute_ms_mean": round(
                    e["execute_s"] * 1e3 / hits, 4
                )
                if hits
                else None,
            }
            if include_cost:
                cost = self._cost_for(key)
                calls = hits + e["compiles"]
                row["flops"] = cost["flops"] if cost else None
                row["bytes_accessed"] = (
                    cost["bytes_accessed"] if cost else None
                )
                row["bytes_accessed_total"] = (
                    cost["bytes_accessed"] * calls
                    if cost and cost["bytes_accessed"] is not None
                    else None
                )
                row["flops_total"] = (
                    cost["flops"] * calls
                    if cost and cost["flops"] is not None
                    else None
                )
            out.append(row)
        if include_cost:
            return sorted(
                out,
                key=lambda r: (
                    -(r.get("bytes_accessed_total") or 0.0),
                    r["model"], r["kind"], r["bucket"],
                ),
            )
        return sorted(
            out, key=lambda r: (r["model"], r["kind"], r["bucket"])
        )

    def reset(self) -> None:
        with self._lock:
            self._programs.clear()
            self._cost_src.clear()
            self._cost.clear()


class DeviceMemorySampler:
    """Background thread sampling device memory on a cadence; the
    ``/metrics`` exporter serves the latest reading."""

    def __init__(self, interval_s: float | None = None) -> None:
        if interval_s is None:
            # a bad env var must not brick imports (this runs at load)
            interval_s = bus.env_float(
                "PYGRID_PROFILER_INTERVAL_S", DEFAULT_SAMPLE_INTERVAL_S
            )
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self._latest: list[dict] = []
        self._sampled_at: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: start()/stop() pairs outstanding — apps in one process share
        #: the sampler; the thread stops with the LAST stop()
        self._starts = 0

    @staticmethod
    def sample_once() -> list[dict]:
        """One synchronous read of every visible card's memory: bytes the
        caching allocator has handed out now and at peak
        (``torch.cuda.memory_stats``), and the card's total
        (``torch.cuda.mem_get_info``). Empty without a GPU; a failing
        read yields no row rather than an exception."""
        try:
            import torch

            if not torch.cuda.is_available():
                return []
            count = torch.cuda.device_count()
        except Exception:  # noqa: BLE001 — no backend is a valid state
            return []
        out = []
        for i in range(count):
            try:
                stats = torch.cuda.memory_stats(i)
                _free, total = torch.cuda.mem_get_info(i)
            except Exception:  # noqa: BLE001 — per-device read optional
                continue
            out.append(
                {
                    "device": str(i),
                    "platform": "gpu",
                    "bytes_in_use": stats.get("allocated_bytes.all.current"),
                    "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                    "bytes_limit": int(total),
                }
            )
        return out

    def latest(self) -> list[dict]:
        """The most recent background sample — never samples inline."""
        with self._lock:
            return [dict(s) for s in self._latest]

    def age_s(self) -> float | None:
        """Seconds since the last background sample (None before the
        first)."""
        with self._lock:
            if self._sampled_at is None:
                return None
            return time.monotonic() - self._sampled_at

    def start(self) -> None:
        """Acquire the sampler. The refcount moves even when the
        profiler is disabled (only the thread spawn is gated)."""
        with self._lock:
            self._starts += 1
            if not enabled():
                return
            if (
                self._thread is not None
                and self._thread.is_alive()
                and not self._stop.is_set()
            ):
                return
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._loop,
                args=(self._stop,),
                name="pygrid-memory-sampler",
                daemon=True,
            )
            self._thread.start()

    def stop(self) -> None:
        """Release one start(); the thread stops when the last holder
        releases."""
        with self._lock:
            self._starts = max(0, self._starts - 1)
            if self._starts > 0:
                return
            thread = self._thread
            self._stop.set()
        if thread is not None:
            thread.join(timeout=2)

    def _loop(self, stop: threading.Event) -> None:
        while True:
            sample = self.sample_once()  # first pass BEFORE the wait
            with self._lock:
                self._latest = sample
                self._sampled_at = time.monotonic()
            if stop.wait(self.interval_s):
                return


#: process-wide instances — same posture as the telemetry bus
PROFILER = JitSiteProfiler()
MEMORY = DeviceMemorySampler()

wrap = PROFILER.wrap
programs_snapshot = PROFILER.snapshot


def export_device_memory(exp) -> None:
    """Write the latest device-memory gauges into an Exposition. No-op
    when disabled or without a GPU."""
    if not enabled():
        return
    for sample in MEMORY.latest():
        labels = {
            "device": sample["device"],
            "platform": sample["platform"],
        }
        for kind in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
            value = sample.get(kind)
            if value is not None:
                exp.gauge(
                    "device_memory_bytes",
                    value,
                    "device memory from torch.cuda.memory_stats, by kind",
                    {**labels, "kind": kind},
                )


def reset() -> None:
    PROFILER.reset()
