"""Worker app — ephemeral FL compute.

Parity surface: reference ``apps/worker/src/__init__.py:1`` is an **empty
stub** (version string only; the real edge executor is syft.js / PySyft's
FLClient on devices). Here the worker is functional: it drives the full
cycle protocol (SURVEY.md §3.3) with the framework's own ``FLClient`` and
executes the downloaded training Plan locally — on TPU when one is
attached, so a single worker process can stand in for thousands of edge
devices by batching its local steps.

The port's counterpart of :mod:`pygrid_tpu.worker`: the worker drives the
port's :class:`~pygrid_tpu_torch.client.FLClient` and trains the node's
plan on ``device`` (default ``"cuda"``; without a GPU that raises unless
``device="cpu"``); placement lookups go through
:mod:`pygrid_tpu_torch.web.client`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

__version__ = "0.1.0"


@dataclass
class WorkerResult:
    accepted: int = 0
    rejected: int = 0
    errors: list[str] = field(default_factory=list)


def default_data_fn(batch_size: int, features: int = 784, classes: int = 10):
    """Synthetic MNIST-shaped batch (the reference worker has no data of its
    own; real deployments pass a ``data_fn`` reading local storage)."""
    import numpy as np

    rng = np.random.default_rng(0)
    X = rng.normal(size=(batch_size, features)).astype("float32")
    y = np.eye(classes, dtype="float32")[
        rng.integers(0, classes, size=batch_size)
    ]
    return X, y


class AggregatorSelector:
    """Per-cycle placement policy for hierarchical aggregation
    (PR-6 follow-up): the worker RE-polls placement every cycle — a
    fresh lookup, never a cached address — and remembers sub-aggregators
    whose report fell back direct, skipping them for a cooldown window
    (``PYGRID_AGG_RETRY_COOLDOWN_S``, default 30 s ≈ 2× the registry
    TTL). Without the cooldown, a dead-but-not-yet-expired subagg that
    placement keeps returning poisons every subsequent round with a
    connect timeout before the direct fallback; without the re-poll, a
    subagg that died AND expired would still be dialed forever."""

    def __init__(self, cooldown_s: float | None = None) -> None:
        import os

        if cooldown_s is None:
            try:
                cooldown_s = float(
                    os.environ.get("PYGRID_AGG_RETRY_COOLDOWN_S", "")
                )
            except (TypeError, ValueError):
                cooldown_s = 30.0
        self.cooldown_s = cooldown_s
        self._failed: dict[str, float] = {}  # addr -> monotonic failure time

    def choose(self, addr: str | None, now: float | None = None) -> str | None:
        """Filter one freshly-polled placement answer: a recently-failed
        address reports direct-to-node instead until its cooldown
        expires (expired entries are pruned — the subagg may be back)."""
        import time as _time

        if addr is None:
            return None
        now = _time.monotonic() if now is None else now
        failed_at = self._failed.get(addr)
        if failed_at is not None:
            if now - failed_at < self.cooldown_s:
                return None
            del self._failed[addr]
        return addr

    def mark_failed(self, addr: str, now: float | None = None) -> None:
        import time as _time

        self._failed[addr] = _time.monotonic() if now is None else now


def lookup_aggregator(
    network_url: str, node_url: str, worker_id: str
) -> str | None:
    """Ask the network's placement for this worker's report target: a
    sub-aggregator address, or None for direct-to-node (no live
    sub-aggregators registered for the node, or no network at all).
    Best-effort by design — the hierarchy is an optimization, so an
    unreachable network must never block a report."""
    from pygrid_tpu_torch.web import client as http

    try:
        resp = http.get(
            network_url.rstrip("/") + "/aggregation/placement",
            params={
                "node-address": node_url.rstrip("/"),
                "worker-id": worker_id,
            },
            timeout=5,
        )
        if resp.status_code == 200:
            return (resp.json() or {}).get("report-to") or None
    except Exception:  # noqa: BLE001 — placement is best-effort
        pass
    return None


def run_worker(
    node_url: str,
    model_name: str,
    model_version: str | None = None,
    auth_token: str | None = None,
    data_fn: Callable[[int], tuple] = default_data_fn,
    cycles: int = 1,
    max_retry_wait: float = 30.0,
    wire: str = "json",
    diff_precision: str | None = None,
    diff_compression: dict | None = None,
    network_url: str | None = None,
    device: str | torch.device = "cuda",
) -> WorkerResult:
    """Participate in up to ``cycles`` FL cycles: authenticate → cycle
    request → download model+plan → local plan execution → report diff.
    A *rejected* cycle carries a retry window the node expects the worker
    to honor (reference fl_controller.py:160-172) — we sleep it (capped at
    ``max_retry_wait``) before the next request. ``wire="binary"`` switches
    the event transport to msgpack frames with raw/bf16 diff payloads.
    ``network_url`` opts into hierarchical aggregation: before each
    report the worker RE-polls the network's placement for its
    sub-aggregator (docs/AGGREGATION.md) — never a cached address, so a
    placement change between cycles is honored — falls back to a direct
    node report when none is live, and remembers a failed sub-aggregator
    for a cooldown window so a dead-but-unexpired subagg cannot poison
    every subsequent round (:class:`AggregatorSelector`). The model
    downloads onto ``device`` and the plan trains there; ``data_fn``'s
    numpy batch crosses to it."""
    import time

    from pygrid_tpu_torch.client.fl_client import FLClient
    from pygrid_tpu_torch.device import resolve

    dev = resolve(device)
    result = WorkerResult()
    client = FLClient(node_url, auth_token=auth_token, wire=wire, device=dev)
    selector = AggregatorSelector()
    try:
        for _ in range(cycles):
            retry_wait = [0.0]
            # placement is per-cycle state: drop the previous cycle's
            # answer so a sparse/compressed cycle (which must report
            # direct) can never inherit a stale subagg address
            client.aggregator_url = None
            assigned = [None]
            job = client.new_job(model_name, model_version)
            job.diff_precision = diff_precision
            job.diff_compression = diff_compression

            def on_accepted(job: Any) -> None:
                if network_url and not (
                    diff_compression or job.client_config.get(
                        "diff_compression"
                    )
                ):
                    # sparse (top-k) diffs skip the tree: a sub-
                    # aggregator folds dense payloads only
                    assigned[0] = selector.choose(
                        lookup_aggregator(
                            network_url, node_url, job.worker_id
                        )
                    )
                    client.aggregator_url = assigned[0]
                plan = job.plans["training_plan"]
                params = job.model_params
                cfg = job.client_config or {}
                batch_size = int(cfg.get("batch_size", 64))
                lr = float(cfg.get("lr", 0.1))
                X, y = data_fn(batch_size)
                out = plan(X, y, lr, *params, device=dev)
                # plan returns (metrics..., *new_params); the param tail is
                # positionally last (reference plan convention, nb 01 cell 16)
                new_params = list(out[-len(params):])
                diff = [p - n for p, n in zip(params, new_params)]
                job.report(diff)
                # plan convention puts metrics first: (loss, acc, *params)
                head = out[: len(out) - len(params)]
                if head:
                    try:
                        client.report_metrics(
                            job.worker_id,
                            job.request_key,
                            loss=float(head[0]),
                            acc=float(head[1]) if len(head) > 1 else None,
                            n_samples=len(X),  # actual rows, not requested
                        )
                    except Exception:  # noqa: BLE001 — metrics are best-effort
                        pass
                result.accepted += 1

            def on_rejected(job: Any, timeout: Any) -> None:
                result.rejected += 1
                if timeout:
                    retry_wait[0] = min(float(timeout), max_retry_wait)

            def on_error(job: Any, err: Exception) -> None:
                result.errors.append(str(err))

            job.add_listener(job.EVENT_ACCEPTED, on_accepted)
            job.add_listener(job.EVENT_REJECTED, on_rejected)
            job.add_listener(job.EVENT_ERROR, on_error)
            job.start()
            if assigned[0] and client.aggregator_url is None:
                # the client cleared the address mid-report: the subagg
                # was unreachable/refusing and the report fell back
                # direct — cool this address down before re-dialing it
                selector.mark_failed(assigned[0])
            if retry_wait[0]:
                time.sleep(retry_wait[0])
    finally:
        client.close()
    return result
