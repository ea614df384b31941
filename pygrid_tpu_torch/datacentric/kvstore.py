"""Key-value store with Redis-hash semantics (the reference's Redis analog):
the port's own copy of :mod:`pygrid_tpu.datacentric.kvstore` (one sqlite
file is readable by both packages).

Parity surface: reference ``data_centric/persistence/database.py:7-15`` — a
module-level ``redis.Redis`` singleton the object/model storages share, using
only the hash commands ``hset/hget/hdel/hgetall/hexists/delete/exists``.
Backends here: :class:`MemoryKV` (tests, single-process) and
:class:`SqliteKV` (durable file — survives node restarts the way the
reference's Redis does).
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Iterator


class KVStore:
    """Hash-structured KV: (name, key) -> bytes."""

    def hset(self, name: str, key: str, value: bytes) -> None:
        raise NotImplementedError

    def hget(self, name: str, key: str) -> bytes | None:
        raise NotImplementedError

    def hdel(self, name: str, *keys: str) -> int:
        raise NotImplementedError

    def hgetall(self, name: str) -> dict[str, bytes]:
        raise NotImplementedError

    def hexists(self, name: str, key: str) -> bool:
        return self.hget(name, key) is not None

    def hkeys(self, name: str) -> list[str]:
        return list(self.hgetall(name))

    def hlen(self, name: str) -> int:
        return len(self.hgetall(name))

    def delete(self, *names: str) -> None:
        raise NotImplementedError

    def exists(self, name: str) -> bool:
        return self.hlen(name) > 0

    def names(self) -> Iterator[str]:
        raise NotImplementedError


class MemoryKV(KVStore):
    def __init__(self) -> None:
        self._data: dict[str, dict[str, bytes]] = {}
        self._lock = threading.RLock()

    def hset(self, name: str, key: str, value: bytes) -> None:
        with self._lock:
            self._data.setdefault(name, {})[key] = bytes(value)

    def hget(self, name: str, key: str) -> bytes | None:
        with self._lock:
            return self._data.get(name, {}).get(key)

    def hdel(self, name: str, *keys: str) -> int:
        with self._lock:
            h = self._data.get(name, {})
            n = 0
            for k in keys:
                if h.pop(k, None) is not None:
                    n += 1
            if not h:
                self._data.pop(name, None)
            return n

    def hgetall(self, name: str) -> dict[str, bytes]:
        with self._lock:
            return dict(self._data.get(name, {}))

    def delete(self, *names: str) -> None:
        with self._lock:
            for n in names:
                self._data.pop(n, None)

    def names(self) -> Iterator[str]:
        with self._lock:
            return iter(list(self._data))


class SqliteKV(KVStore):
    """Durable backend: one table (name, key, value) in a sqlite file."""

    def __init__(self, path: str = ":memory:") -> None:
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv ("
                " name TEXT NOT NULL, key TEXT NOT NULL, value BLOB,"
                " PRIMARY KEY (name, key))"
            )
            self._conn.commit()

    def hset(self, name: str, key: str, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv (name, key, value) VALUES (?, ?, ?)"
                " ON CONFLICT(name, key) DO UPDATE SET value = excluded.value",
                (name, key, sqlite3.Binary(bytes(value))),
            )
            self._conn.commit()

    def hget(self, name: str, key: str) -> bytes | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM kv WHERE name = ? AND key = ?", (name, key)
            ).fetchone()
        return bytes(row[0]) if row else None

    def hdel(self, name: str, *keys: str) -> int:
        if not keys:
            return 0
        with self._lock:
            cur = self._conn.execute(
                f"DELETE FROM kv WHERE name = ? AND key IN "
                f"({','.join('?' * len(keys))})",
                (name, *keys),
            )
            self._conn.commit()
            return cur.rowcount

    def hgetall(self, name: str) -> dict[str, bytes]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, value FROM kv WHERE name = ?", (name,)
            ).fetchall()
        return {k: bytes(v) for k, v in rows}

    def delete(self, *names: str) -> None:
        with self._lock:
            self._conn.executemany(
                "DELETE FROM kv WHERE name = ?", [(n,) for n in names]
            )
            self._conn.commit()

    def names(self) -> Iterator[str]:
        with self._lock:
            rows = self._conn.execute("SELECT DISTINCT name FROM kv").fetchall()
        return iter([r[0] for r in rows])
