"""SQL datasource: dialect-aware wrapper with per-query logging + metrics.

Parity with gofr `pkg/gofr/datasource/sql/`: DSN built from ``DB_*`` config with
dialect switch (`sql.go:168-188`), lazy skip when unconfigured (`sql.go:43-46`),
every query wrapped with a debug log + ``app_sql_stats`` histogram
(`db.go:47-105`), transactions, a reflection-free ``select_into`` helper, a
dialect-quoted CRUD query builder (`query_builder.go`), and health checks.

In-tree driver: sqlite3 (stdlib). mysql/postgres engage automatically when
their drivers are importable; a dialect without its driver, or an unknown one,
raises at boot (JAX's logs a warning and leaves SQL unwired: ROADMAP.md
Queue C).

The port's own copy of gofr_tpu/datasource/sql.py.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from dataclasses import is_dataclass, fields as dc_fields
from typing import Any, Iterable, Sequence

from gofr_tpu_torch.datasource import DatasourceError


class Row(dict):
    """A result row: dict with attribute access."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


class DB:
    """Thread-safe SQL access with logging + metrics on every call."""

    def __init__(self, conn, dialect: str, logger, metrics, placeholder: str = "?"):
        self._conn = conn
        self.dialect = dialect
        self._logger = logger
        self._metrics = metrics
        self._placeholder = placeholder
        self._lock = threading.RLock()

    # -- core ------------------------------------------------------------------

    def _normalize(self, query: str) -> str:
        # user-facing queries use '?'; translate for drivers with '%s' paramstyle.
        # (literal '?' inside SQL string literals is not supported on those dialects)
        if self._placeholder != "?":
            return query.replace("?", self._placeholder)
        return query

    def _observe(self, kind: str, query: str, start: float) -> None:
        dur = time.perf_counter() - start
        if self._metrics is not None:
            self._metrics.record_histogram("app_sql_stats", dur, type=kind)
        if self._logger is not None:
            self._logger.debug({"message": "sql", "query": query.strip()[:200], "duration_us": int(dur * 1e6), "type": kind})

    def query(self, query: str, params: Sequence[Any] = ()) -> list[Row]:
        start = time.perf_counter()
        with self._lock:
            try:
                cur = self._conn.execute(self._normalize(query), tuple(params))
                cols = [d[0] for d in cur.description] if cur.description else []
                rows = [Row(zip(cols, r)) for r in cur.fetchall()]
                # close the implicit read transaction (postgres would otherwise
                # sit idle-in-transaction; harmless no-op on sqlite)
                self._conn.commit()
            except Exception as e:  # noqa: BLE001
                try:
                    self._conn.rollback()  # clear aborted-transaction state
                except Exception:  # noqa: BLE001
                    pass
                raise DatasourceError(e) from e
        self._observe("query", query, start)
        return rows

    def query_row(self, query: str, params: Sequence[Any] = ()) -> Row | None:
        rows = self.query(query, params)
        return rows[0] if rows else None

    def execute(self, query: str, params: Sequence[Any] = ()) -> int:
        start = time.perf_counter()
        with self._lock:
            try:
                cur = self._conn.execute(self._normalize(query), tuple(params))
                self._conn.commit()
                affected = cur.rowcount
            except Exception as e:  # noqa: BLE001
                self._conn.rollback()
                raise DatasourceError(e) from e
        self._observe("exec", query, start)
        return affected

    def execute_many(self, query: str, seq_of_params: Iterable[Sequence[Any]]) -> int:
        start = time.perf_counter()
        with self._lock:
            try:
                cur = self._conn.executemany(self._normalize(query), [tuple(p) for p in seq_of_params])
                self._conn.commit()
                affected = cur.rowcount
            except Exception as e:  # noqa: BLE001
                self._conn.rollback()
                raise DatasourceError(e) from e
        self._observe("exec_many", query, start)
        return affected

    def select_into(self, cls: type, query: str, params: Sequence[Any] = ()) -> list[Any]:
        """Bind rows into dataclass instances (analog of gofr's reflective Select)."""
        rows = self.query(query, params)
        if not is_dataclass(cls):
            raise DatasourceError(f"select_into target must be a dataclass, got {cls!r}")
        names = {f.name for f in dc_fields(cls)}
        return [cls(**{k: v for k, v in row.items() if k in names}) for row in rows]

    # -- transactions ----------------------------------------------------------

    def begin(self) -> "Tx":
        return Tx(self)

    # -- lifecycle -------------------------------------------------------------

    def health_check(self) -> dict[str, Any]:
        try:
            with self._lock:
                self._conn.execute("SELECT 1")
            return {"status": "UP", "details": {"dialect": self.dialect}}
        except Exception as e:  # noqa: BLE001
            return {"status": "DOWN", "details": {"dialect": self.dialect, "error": str(e)}}

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class Tx:
    """Transaction: all statements commit together or roll back on error."""

    def __init__(self, db: DB):
        self._db = db
        self._done = False

    def __enter__(self) -> "Tx":
        self._db._lock.acquire()
        return self

    def query(self, query: str, params: Sequence[Any] = ()) -> list[Row]:
        cur = self._db._conn.execute(self._db._normalize(query), tuple(params))
        cols = [d[0] for d in cur.description] if cur.description else []
        return [Row(zip(cols, r)) for r in cur.fetchall()]

    def execute(self, query: str, params: Sequence[Any] = ()) -> int:
        return self._db._conn.execute(self._db._normalize(query), tuple(params)).rowcount

    def commit(self) -> None:
        self._db._conn.commit()
        self._done = True

    def rollback(self) -> None:
        self._db._conn.rollback()
        self._done = True

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc is not None:
                self._db._conn.rollback()
            elif not self._done:
                self._db._conn.commit()
        finally:
            self._db._lock.release()


# -- query builder (gofr `datasource/sql/query_builder.go`) --------------------

_QUOTES = {"mysql": "`", "sqlite": '"', "postgres": '"'}


def quote_ident(name: str, dialect: str) -> str:
    q = _QUOTES.get(dialect, '"')
    safe = "".join(ch for ch in name if ch.isalnum() or ch == "_")
    return f"{q}{safe}{q}"


def insert_query(table: str, columns: Sequence[str], dialect: str) -> str:
    cols = ", ".join(quote_ident(c, dialect) for c in columns)
    ph = ", ".join(["?"] * len(columns))
    return f"INSERT INTO {quote_ident(table, dialect)} ({cols}) VALUES ({ph})"


def select_all_query(table: str, dialect: str) -> str:
    return f"SELECT * FROM {quote_ident(table, dialect)}"


def select_by_query(table: str, key: str, dialect: str) -> str:
    return f"SELECT * FROM {quote_ident(table, dialect)} WHERE {quote_ident(key, dialect)} = ?"


def update_query(table: str, columns: Sequence[str], key: str, dialect: str) -> str:
    sets = ", ".join(f"{quote_ident(c, dialect)} = ?" for c in columns)
    return f"UPDATE {quote_ident(table, dialect)} SET {sets} WHERE {quote_ident(key, dialect)} = ?"


def delete_query(table: str, key: str, dialect: str) -> str:
    return f"DELETE FROM {quote_ident(table, dialect)} WHERE {quote_ident(key, dialect)} = ?"


# -- connection factory --------------------------------------------------------


def connect_sql(config, logger, metrics) -> DB:
    dialect = (config.get("DB_DIALECT") or "sqlite").lower()
    if dialect in ("sqlite", "sqlite3"):
        name = config.get_or_default("DB_NAME", ":memory:")
        conn = sqlite3.connect(name, check_same_thread=False)
        conn.execute("PRAGMA journal_mode=WAL") if name != ":memory:" else None
        logger.infof("connected to sqlite database %s", name)
        return DB(conn, "sqlite", logger, metrics)
    if dialect == "mysql":
        try:
            import pymysql  # type: ignore[import-not-found]
        except ImportError as e:
            raise DatasourceError(e, "DB_DIALECT=mysql but the pymysql driver is not "
                                     "installed") from e
        conn = pymysql.connect(
            host=config.get_or_default("DB_HOST", "localhost"),
            port=config.get_int("DB_PORT", 3306),
            user=config.get_or_default("DB_USER", "root"),
            password=config.get_or_default("DB_PASSWORD", ""),
            database=config.get_or_default("DB_NAME", ""),
            autocommit=False,
        )
        return DB(_DBAPIAdapter(conn), "mysql", logger, metrics, placeholder="%s")
    if dialect in ("postgres", "postgresql"):
        try:
            import psycopg2  # type: ignore[import-not-found]
        except ImportError as e:
            raise DatasourceError(e, "DB_DIALECT=postgres but the psycopg2 driver is not "
                                     "installed") from e
        conn = psycopg2.connect(
            host=config.get_or_default("DB_HOST", "localhost"),
            port=config.get_int("DB_PORT", 5432),
            user=config.get_or_default("DB_USER", "postgres"),
            password=config.get_or_default("DB_PASSWORD", ""),
            dbname=config.get_or_default("DB_NAME", "postgres"),
        )
        return DB(_DBAPIAdapter(conn), "postgres", logger, metrics, placeholder="%s")
    raise DatasourceError(f"unknown DB_DIALECT {dialect!r}; use sqlite, mysql or postgres")


class _DBAPIAdapter:
    """Adapts cursor-style DBAPI drivers to sqlite3's connection.execute style."""

    def __init__(self, conn):
        self._conn = conn

    def execute(self, query: str, params: Sequence[Any] = ()):
        cur = self._conn.cursor()
        cur.execute(query, params)
        return cur

    def executemany(self, query: str, seq: Sequence[Sequence[Any]]):
        cur = self._conn.cursor()
        cur.executemany(query, seq)
        return cur

    def commit(self) -> None:
        self._conn.commit()

    def rollback(self) -> None:
        self._conn.rollback()

    def close(self) -> None:
        self._conn.close()
