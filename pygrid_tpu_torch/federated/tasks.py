"""Deduplicated background task execution.

Parity surface: reference ``model_centric/tasks/cycle.py:9-37`` —
``run_task_once`` prevents concurrent ``complete_cycle`` runs for the same
key on the Flask-Executor pool. Here a plain thread + an in-flight key set;
``set_sync(True)`` makes execution synchronous (tests, and the asyncio node
app which supplies its own executor).

The port's copy of :mod:`pygrid_tpu.federated.tasks`, with the port's imports.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Callable

logger = logging.getLogger(__name__)


class _DaemonPool:
    """Elastic daemon worker threads (instead of a fresh thread per
    trigger — the report path triggers a readiness check per diff, and
    thread spawn costs more than the check itself). Daemon matters: a
    task wedged on a dead device must not block interpreter exit
    the way concurrent.futures' atexit join would. Elastic matters: when
    every worker is busy (or wedged), a new submission grows the pool up
    to MAX_WORKERS so slow tasks cannot starve every other FL process's
    readiness checks."""

    MAX_WORKERS = 32

    def __init__(self, workers: int = 4) -> None:
        self._q: queue.Queue[Callable[[], None]] = queue.Queue()
        self._idle = 0
        self._n = 0
        self._grow_lock = threading.Lock()
        for _ in range(workers):
            self._spawn()

    def _spawn(self) -> None:
        """Under the lock: ``submit`` grows the pool while holding
        ``_grow_lock``; the ``__init__`` calls are pre-publication
        (single-threaded by definition)."""
        self._n += 1
        threading.Thread(
            target=self._loop, name=f"task-{self._n}", daemon=True
        ).start()

    def _loop(self) -> None:
        while True:
            with self._grow_lock:
                self._idle += 1
            try:
                job = self._q.get()
            finally:
                with self._grow_lock:
                    self._idle -= 1
            try:
                job()
            except Exception:  # noqa: BLE001 — background boundary
                logger.exception("background task failed")

    def submit(self, job: Callable[[], None]) -> None:
        with self._grow_lock:
            if self._idle == 0 and self._n < self.MAX_WORKERS:
                self._spawn()
        self._q.put(job)


_pool: _DaemonPool | None = None
_pool_lock = threading.Lock()


def _executor() -> _DaemonPool:
    global _pool
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                _pool = _DaemonPool()
    return _pool

# key -> {"status": "running" | "rerun", "call": (fn, args)}. A trigger that
# arrives while running must not be dropped: the running pass may have read
# state from before the trigger's write — e.g. the final diff landing during
# a readiness check — so the task re-runs once, with the latest call's args.
_state: dict[str, dict[str, Any]] = {}
_lock = threading.Lock()
_sync = False


def set_sync(sync: bool) -> None:
    global _sync
    _sync = sync


def run_task_once(key: str, fn: Callable, *args: Any) -> None:
    """Run ``fn(*args)``; coalesce concurrent triggers to one pending rerun."""
    with _lock:
        if key in _state:
            _state[key] = {"status": "rerun", "call": (fn, args)}
            logger.debug("task %s in flight — rerun queued", key)
            return
        _state[key] = {"status": "running", "call": (fn, args)}

    def _run() -> None:
        while True:
            with _lock:
                run_fn, run_args = _state[key]["call"]
            try:
                run_fn(*run_args)
            except Exception:  # noqa: BLE001 — background boundary
                logger.exception("background task %s failed", key)
            with _lock:
                if _state.get(key, {}).get("status") == "rerun":
                    _state[key]["status"] = "running"
                    continue
                _state.pop(key, None)
                return

    if _sync:
        _run()
    else:
        _executor().submit(_run)
