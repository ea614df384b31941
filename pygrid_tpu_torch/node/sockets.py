"""Socket ↔ worker-id registry.

Parity surface: reference ``events/socket_handler.py:13-63`` — a singleton
mapping worker ids to live sockets so FL events can push to a specific
worker, and so a dropped socket unregisters its worker. Here one instance
per app (no module singleton), keyed by the WebSocketResponse. The port's
copy of :mod:`pygrid_tpu.node.sockets`.
"""

from __future__ import annotations

from typing import Any


class SocketHandler:
    def __init__(self) -> None:
        self._by_worker: dict[str, Any] = {}
        self._by_socket: dict[int, str] = {}

    def new_connection(self, worker_id: str, socket: Any) -> None:
        self._by_worker[worker_id] = socket
        if socket is not None:
            self._by_socket[id(socket)] = worker_id

    def socket_of(self, worker_id: str) -> Any | None:
        return self._by_worker.get(worker_id)

    def worker_of(self, socket: Any) -> str | None:
        return self._by_socket.get(id(socket))

    def remove(self, socket: Any) -> str | None:
        """Unregister the worker bound to this socket (fixes the reference's
        return-inside-loop bug, socket_handler.py:43-55 — noted SURVEY §5.2)."""
        worker_id = self._by_socket.pop(id(socket), None)
        if worker_id is not None:
            self._by_worker.pop(worker_id, None)
        return worker_id

    def __len__(self) -> int:
        return len(self._by_worker)
