"""Warehouse — a generic repository over a pluggable SQL engine: the port's
own copy of :mod:`pygrid_tpu.storage.warehouse` (the same tables, columns and
serde blobs, so one database file serves either package).

Parity surface: the reference's ``Warehouse(schema)`` generic ORM wrapper
(``apps/node/src/app/main/core/warehouse.py:6-92``:
register/query/first/last/count/contains/delete/modify/update over any
SQLAlchemy schema) and its any-``DATABASE_URL`` posture
(``apps/node/src/app/__init__.py:54-59``). Here schemas are plain
dataclasses (no SQLAlchemy in the image); column DDL is derived from
dataclass field types, dict fields are stored as serde blobs (the
reference's PickleType analog). Two engines sit behind one ``Database``
facade, selected by URL scheme:

- **sqlite** (default; ``:memory:``, a path, or ``sqlite://...``):
  in-memory for the test/bench posture, or file-backed WAL with
  per-thread connections so the node's concurrent executor threads
  don't serialize through one lock.
- **postgres** (``postgres://`` / ``postgresql://``): the client-server
  backend horizontal deployments share — N node processes against one
  coordination database (the reference's Aurora-serverless posture,
  ``deploy/serverless-node/database.tf:1-6``) — spoken over the
  dependency-free wire client in :mod:`pygrid_tpu_torch.storage.pgwire` and
  pooled exactly like the sqlite file connections.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime as dt
import sqlite3
import threading
from typing import Any, Iterator, Sequence, Type, TypeVar

from pygrid_tpu_torch.serde import deserialize, serialize

T = TypeVar("T")

_SQL_TYPES = {
    int: "INTEGER",
    float: "REAL",
    str: "TEXT",
    bool: "INTEGER",
    bytes: "BLOB",
    dict: "BLOB",
    dt.datetime: "TEXT",
}

#: sqlite storage class → postgres column type
_PG_TYPES = {
    "INTEGER": "BIGINT",
    "REAL": "DOUBLE PRECISION",
    "TEXT": "TEXT",
    "BLOB": "BYTEA",
}


def _column_type(py_type: Any) -> str:
    # unwrap Optional[...] / "X | None" annotations
    for t, sql in _SQL_TYPES.items():
        if py_type is t:
            return sql
        name = getattr(py_type, "__name__", str(py_type))
        if name == t.__name__ or str(py_type).replace(" | None", "") in (
            t.__name__,
            f"datetime.{t.__name__}",
        ):
            return sql
    return "BLOB"


def _qmark_to_dollar(sql: str) -> str:
    """Rewrite ``?`` placeholders to postgres ``$n``, skipping quoted
    spans (a ``?`` inside a string literal — e.g. a migrated column
    DEFAULT — must survive verbatim)."""
    out = []
    n = 0
    in_str = False
    for ch in sql:
        if ch == "'":
            in_str = not in_str
            out.append(ch)
        elif ch == "?" and not in_str:
            n += 1
            out.append(f"${n}")
        else:
            out.append(ch)
    return "".join(out)


def _encode(value: Any, py_type: Any) -> Any:
    if value is None:
        return None
    if isinstance(value, dict):
        return serialize(value)
    if isinstance(value, dt.datetime):
        return value.isoformat()
    if isinstance(value, bool):
        return int(value)
    return value


def _decode(value: Any, py_type: Any) -> Any:
    if value is None:
        return None
    type_str = str(py_type)
    if "dict" in type_str and isinstance(value, bytes):
        return deserialize(value)
    if "datetime" in type_str and isinstance(value, str):
        return dt.datetime.fromisoformat(value)
    if "bool" in type_str:
        return bool(value)
    return value


class _Result:
    """Materialized query result (cursor-shaped: fetchone/fetchall/lastrowid).
    Rows are fetched before the backing connection is released, so results
    never alias a connection another thread may be using."""

    __slots__ = ("_rows", "lastrowid", "_i")

    def __init__(self, rows: list, lastrowid: int | None) -> None:
        self._rows = rows
        self.lastrowid = lastrowid
        self._i = 0

    def fetchall(self) -> list:
        rows, self._i = self._rows[self._i :], len(self._rows)
        return rows

    def fetchone(self):
        if self._i >= len(self._rows):
            return None
        row = self._rows[self._i]
        self._i += 1
        return row

    def __iter__(self):
        return iter(self.fetchall())


class Database:
    """The SQL handle shared by all warehouses (engine picked by URL).

    sqlite file databases get **WAL + one connection per thread**: readers
    never block behind the writer, and concurrent report/readiness/checkpoint
    traffic from the node's executor threads doesn't serialize through one
    process-wide lock. In-memory databases (the test/bench posture) keep a
    single connection behind an RLock — WAL doesn't exist for ``:memory:``
    and sqlite shared-cache's table-level SQLITE_LOCKED errors (which ignore
    ``busy_timeout``) are strictly worse than a short lock under the GIL.
    ``postgres://`` URLs pool :class:`pygrid_tpu_torch.storage.pgwire.
    PgConnection` sockets the same way file connections pool.
    """

    #: connections kept warm for reuse; beyond this, a released connection
    #: closes instead of pooling (bounds fds regardless of thread churn —
    #: short-lived task threads would otherwise leak one fd each)
    POOL_SIZE = 8

    def __init__(self, url: str = ":memory:") -> None:
        self.dialect = (
            "postgres"
            if url.startswith(("postgres://", "postgresql://"))
            else "sqlite"
        )
        self._pool: list = []
        self._pool_lock = threading.Lock()
        if self.dialect == "postgres":
            from pygrid_tpu_torch.storage.pgwire import parse_pg_url

            self._pg_kwargs = parse_pg_url(url)
            self._conn = None
            self._lock = None
            self._is_memory = False
            with self._connection() as _:
                pass  # probe: fail fast on unreachable/unauthorized server
            return
        if url.startswith("sqlite://"):
            # SQLAlchemy path semantics: sqlite:///rel.db is relative,
            # sqlite:////abs/path.db is absolute — strip the scheme and
            # exactly ONE path slash (lstripping all of them silently
            # turned every absolute path relative to the server's cwd)
            rest = url[len("sqlite://") :]
            if rest.startswith("/"):
                rest = rest[1:]
            url = rest or ":memory:"
        self._url = url
        self._is_memory = url == ":memory:"
        if self._is_memory:
            self._conn = sqlite3.connect(url, check_same_thread=False)
            self._conn.row_factory = sqlite3.Row
            self._lock: threading.RLock | None = threading.RLock()
        else:
            self._conn = None
            self._lock = None
            with self._connection() as _:
                pass  # probe: fail fast on an unopenable path

    def _new_connection(self):
        if self.dialect == "postgres":
            from pygrid_tpu_torch.storage.pgwire import PgConnection

            return PgConnection(**self._pg_kwargs)
        return self._new_sqlite_connection()

    def _new_sqlite_connection(self) -> sqlite3.Connection:
        # check_same_thread=False: the pool hands each connection to exactly
        # one thread at a time (sqlite objects are fine serially cross-thread)
        conn = sqlite3.connect(self._url, timeout=30.0, check_same_thread=False)
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        conn.execute("PRAGMA busy_timeout=30000")
        return conn

    @contextlib.contextmanager
    def _connection(self) -> Iterator[Any]:
        with self._pool_lock:
            conn = self._pool.pop() if self._pool else None
        if conn is None:
            conn = self._new_connection()
        try:
            yield conn
        except BaseException:
            # never re-pool a connection mid-transaction: the next borrower
            # would silently commit (or read inside) the failed statement.
            # (pg: a PgError leaves the session at ReadyForQuery, but a
            # socket-level failure leaves it unusable — drop either way)
            try:
                if self.dialect == "sqlite":
                    conn.rollback()
            finally:
                conn.close()
            raise
        with self._pool_lock:
            keep = len(self._pool) < self.POOL_SIZE
            if keep:
                self._pool.append(conn)
        if not keep:
            conn.close()

    #: pooled pg connections idle longer than this are closed on
    #: checkout instead of reused — the server (or an RDS failover) may
    #: have dropped them, and a write on a dead socket cannot be safely
    #: retried (the statement may have committed before the reply died)
    PG_RECYCLE_S = 60.0

    def _pg_checkout(self):
        """A pooled-and-fresh-enough connection, or None."""
        import time

        stale = []
        conn = None
        with self._pool_lock:
            while self._pool:
                cand = self._pool.pop()
                age = time.monotonic() - getattr(cand, "_pooled_at", 0.0)
                if age <= self.PG_RECYCLE_S:
                    conn = cand
                    break
                stale.append(cand)
        for c in stale:
            c.close()
        return conn

    def execute(self, sql: str, params: tuple = ()) -> "_Result":
        if self.dialect == "postgres":
            import time

            from pygrid_tpu_torch.storage.pgwire import PgConnectionLost

            # Retry policy: a pooled socket can die idle (server
            # timeout, failover). Reads are idempotent — retried once on
            # a FRESH connection (never another pool pop: after a
            # failover every pooled socket is dead). Writes are not
            # retried at all: TCP cannot distinguish "died before the
            # server saw it" from "committed but the reply was lost",
            # and a double-applied INSERT is worse than a typed error.
            # The idle-recycle in _pg_checkout keeps that case rare.
            is_read = sql.lstrip()[:6].upper() == "SELECT"
            for attempt in (0, 1):
                conn = self._pg_checkout() if attempt == 0 else None
                pooled = conn is not None
                if conn is None:
                    conn = self._new_connection()
                try:
                    rows, _ = conn.execute(_qmark_to_dollar(sql), params)
                except PgConnectionLost:
                    conn.close()
                    if pooled and is_read and attempt == 0:
                        continue
                    raise
                except BaseException:
                    conn.close()
                    raise
                conn._pooled_at = time.monotonic()
                with self._pool_lock:
                    keep = len(self._pool) < self.POOL_SIZE
                    if keep:
                        self._pool.append(conn)
                if not keep:
                    conn.close()
                # postgres has no lastrowid; Warehouse.register appends
                # RETURNING id and reads it off the first row
                lastrowid = None
                if rows and sql.rstrip().upper().endswith("RETURNING ID"):
                    lastrowid = rows[0][0]
                return _Result(rows, lastrowid)
        # SELECTs never open a write transaction (autocommit mode), so the
        # commit would be a no-op round trip — skipped; the protocol hot
        # paths run several point reads per message
        is_read = sql.lstrip()[:6].upper() == "SELECT"
        if self._is_memory:
            with self._lock:
                cur = self._conn.execute(sql, params)
                if not is_read:
                    self._conn.commit()
                return _Result(cur.fetchall() if cur.description else [], cur.lastrowid)
        with self._connection() as conn:
            # materialize before the connection returns to the pool —
            # a live cursor on a re-leased connection is a data race
            cur = conn.execute(sql, params)
            rows = cur.fetchall() if cur.description else []
            lastrowid = cur.lastrowid
            if not is_read:
                conn.commit()
            return _Result(rows, lastrowid)

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
        with self._pool_lock:
            for conn in self._pool:
                conn.close()
            self._pool.clear()


class Warehouse:
    """Typed repository for one dataclass schema.

    The schema's first field named ``id`` is the primary key; ``int`` ids
    autoincrement, ``str`` ids are caller-assigned (the reference's Worker
    uses string ids — ``workers/worker.py:4-25``).
    """

    def __init__(self, schema: Type[T], db: Database) -> None:
        if not dataclasses.is_dataclass(schema):
            raise TypeError("Warehouse schema must be a dataclass")
        self.schema = schema
        self.db = db
        self.table = '"' + schema.__name__.lower() + '"'  # quoted: "group"/"user" are reserved words
        self.fields = dataclasses.fields(schema)
        self._field_types = {f.name: f.type for f in self.fields}
        #: columns ADD'ed by this construction's migration — callers that
        #: need semantic backfill beyond the column DEFAULT (e.g. marking
        #: pre-upgrade FedBuff rows as already-flushed) key off this
        self.migrated_columns: set[str] = set()
        self._create_table()

    def _coltype(self, py_type: Any) -> str:
        base = _column_type(py_type)
        if self.db.dialect == "postgres":
            return _PG_TYPES[base]
        return base

    def _create_table(self) -> None:
        pg = self.db.dialect == "postgres"
        cols = []
        for f in self.fields:
            col = f'"{f.name}" {self._coltype(f.type)}'
            if f.name == "id":
                if _column_type(f.type) == "INTEGER":
                    col = (
                        "id BIGSERIAL PRIMARY KEY"
                        if pg
                        else "id INTEGER PRIMARY KEY AUTOINCREMENT"
                    )
                else:
                    col = "id TEXT PRIMARY KEY"
            cols.append(col)
        if pg:
            # insertion-order column standing in for sqlite's implicit
            # rowid — last() orders by it
            cols.append('"_seq" BIGSERIAL')
        self.db.execute(
            f"CREATE TABLE IF NOT EXISTS {self.table} ({', '.join(cols)})"
        )
        self._migrate_missing_columns()
        # schema-declared secondary indexes (``SQL_INDEXES`` on the
        # dataclass): the protocol hot paths look rows up by worker/cycle
        # keys thousands of times per cycle — full scans were fine at 64
        # workers and are the wall at 10k
        for index_cols in getattr(self.schema, "SQL_INDEXES", ()):
            cols_sql = ", ".join(f'"{c}"' for c in index_cols)
            name = "ix_{}_{}".format(
                self.schema.__name__.lower(), "_".join(index_cols)
            )
            self.db.execute(
                f'CREATE INDEX IF NOT EXISTS "{name}" '
                f"ON {self.table} ({cols_sql})"
            )

    @property
    def _order_rowid(self) -> str:
        return '"_seq"' if self.db.dialect == "postgres" else "rowid"

    def _existing_columns(self) -> set[str]:
        if self.db.dialect == "postgres":
            # current_schema() filter: a same-named table in another
            # schema of a shared database must not make a column look
            # "existing" and suppress the migration
            return {
                row[0]
                for row in self.db.execute(
                    "SELECT column_name FROM information_schema.columns "
                    "WHERE table_name = ? "
                    "AND table_schema = current_schema()",
                    (self.table.strip('"'),),
                ).fetchall()
            }
        return {
            row[1]
            for row in self.db.execute(
                f"PRAGMA table_info({self.table})"
            ).fetchall()
        }

    def _migrate_missing_columns(self) -> None:
        """Schema evolution for durable DBs: a dataclass can grow
        fields across releases, but register() always INSERTs every field
        — without ALTER TABLE, a node restarted on an old DB would fail
        its first write. Scalar dataclass defaults are emitted as column
        DEFAULTs so the engine backfills PRE-migration rows with them;
        fields defaulting to None (or with non-scalar defaults) read back
        None for old rows."""
        existing = self._existing_columns()
        for f in self.fields:
            if f.name in existing:
                continue
            self.migrated_columns.add(f.name)
            ddl = (
                f"ALTER TABLE {self.table} ADD COLUMN "
                f'"{f.name}" {self._coltype(f.type)}'
            )
            default = getattr(f, "default", None)
            if isinstance(default, bool):
                ddl += f" DEFAULT {int(default)}"
            elif isinstance(default, (int, float)):
                ddl += f" DEFAULT {default!r}"
            elif isinstance(default, str):
                escaped = default.replace("'", "''")
                ddl += f" DEFAULT '{escaped}'"
            self.db.execute(ddl)

    # --- write --------------------------------------------------------------

    def register(self, **kwargs: Any) -> T:
        obj = self.schema(**kwargs)
        names, values = [], []
        for f in self.fields:
            v = getattr(obj, f.name)
            if f.name == "id" and v is None:
                continue
            names.append(f'"{f.name}"')
            values.append(_encode(v, f.type))
        sql = (
            f"INSERT INTO {self.table} ({', '.join(names)}) "
            f"VALUES ({', '.join('?' * len(names))})"
        )
        needs_id = getattr(obj, "id", None) is None
        if needs_id and self.db.dialect == "postgres":
            sql += " RETURNING id"
        cur = self.db.execute(sql, tuple(values))
        if needs_id:
            object.__setattr__(obj, "id", cur.lastrowid)
        return obj

    def modify(self, filters: dict, updates: dict) -> None:
        where, params = self._where(filters)
        sets = ", ".join(f'"{k}" = ?' for k in updates)
        set_params = tuple(
            _encode(v, self._field_types.get(k)) for k, v in updates.items()
        )
        self.db.execute(
            f"UPDATE {self.table} SET {sets}{where}", set_params + params
        )

    update = modify  # reference exposes both spellings

    def delete(self, **filters: Any) -> None:
        where, params = self._where(filters)
        self.db.execute(f"DELETE FROM {self.table}{where}", params)

    # --- read ---------------------------------------------------------------

    def _where(self, filters: dict) -> tuple[str, tuple]:
        if not filters:
            return "", ()
        clauses, params = [], []
        for k, v in filters.items():
            if v is None:
                clauses.append(f'"{k}" IS NULL')
            elif isinstance(v, (list, tuple, set)):
                # membership filter → SQL IN: the batch UPDATE/SELECT the
                # hierarchical report path needs (one statement for a
                # whole subtree's rows, not one per worker)
                values = list(v)
                if not values:
                    clauses.append("1 = 0")  # empty set matches nothing
                else:
                    marks = ", ".join("?" for _ in values)
                    clauses.append(f'"{k}" IN ({marks})')
                    params.extend(
                        _encode(x, self._field_types.get(k)) for x in values
                    )
            else:
                clauses.append(f'"{k}" = ?')
                params.append(_encode(v, self._field_types.get(k)))
        return " WHERE " + " AND ".join(clauses), tuple(params)

    def _row_to_obj(self, row: sqlite3.Row) -> T:
        kwargs = {
            f.name: _decode(row[f.name], f.type)
            for f in self.fields
            if f.name in row.keys()
        }
        return self.schema(**kwargs)

    def _select(self, columns=None) -> str:
        """Column projection: rows materialize with only the named fields
        (the rest keep their dataclass defaults). Metadata scans over
        tables with megabyte blob columns (WorkerCycle.diff,
        ModelCheckPoint.value) must not drag the blobs through sqlite —
        the hot FL report path queries per report."""
        if not columns:
            return "*"
        valid = {f.name for f in self.fields}
        unknown = set(columns) - valid
        if unknown:
            raise KeyError(f"unknown column(s) {sorted(unknown)}")
        return ", ".join(f'"{c}"' for c in columns)

    def query(
        self,
        order_by: str | None = None,
        columns: Sequence[str] | None = None,
        **filters: Any,
    ) -> list[T]:
        where, params = self._where(filters)
        order = f' ORDER BY "{order_by}"' if order_by else ""
        cur = self.db.execute(
            f"SELECT {self._select(columns)} FROM {self.table}{where}{order}",
            params,
        )
        return [self._row_to_obj(r) for r in cur.fetchall()]

    def first(
        self, columns: Sequence[str] | None = None, **filters: Any
    ) -> T | None:
        where, params = self._where(filters)
        cur = self.db.execute(
            f"SELECT {self._select(columns)} FROM {self.table}{where} LIMIT 1",
            params,
        )
        row = cur.fetchone()
        return self._row_to_obj(row) if row else None

    def last(
        self, columns: Sequence[str] | None = None, **filters: Any
    ) -> T | None:
        where, params = self._where(filters)
        cur = self.db.execute(
            f"SELECT {self._select(columns)} FROM {self.table}{where} "
            f"ORDER BY {self._order_rowid} DESC LIMIT 1",
            params,
        )
        row = cur.fetchone()
        return self._row_to_obj(row) if row else None

    def count(self, **filters: Any) -> int:
        where, params = self._where(filters)
        cur = self.db.execute(
            f"SELECT COUNT(*) AS n FROM {self.table}{where}", params
        )
        return int(cur.fetchone()["n"])

    def contains(self, **filters: Any) -> bool:
        return self.count(**filters) > 0

    def __iter__(self) -> Iterator[T]:
        return iter(self.query())
