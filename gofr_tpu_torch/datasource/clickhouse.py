"""Clickhouse datasource plugin (gofr `pkg/gofr/datasource/clickhouse/`,
separate-module tier — SURVEY.md §2.4).

Exec / Select / AsyncInsert surface (`clickhouse.go`) over an injectable
``client_factory``; connection-pool gauges pushed on health checks
(`clickhouse.go:62-66` analog). ``InMemoryClickhouse`` reuses the sqlite
engine underneath for a hermetic, SQL-true fake.

The port's own copy of gofr_tpu/datasource/clickhouse.py.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from gofr_tpu_torch.datasource import DatasourceError


class Clickhouse:
    def __init__(
        self,
        dsn: str | None = None,
        client_factory: Callable[..., Any] | None = None,
    ):
        self._dsn = dsn
        self._client_factory = client_factory
        self._client = None
        self.logger = None
        self.metrics = None

    # -- provider lifecycle ----------------------------------------------------

    def use_logger(self, logger) -> None:
        self.logger = logger

    def use_metrics(self, metrics) -> None:
        self.metrics = metrics
        try:
            metrics.new_histogram(
                "app_clickhouse_stats", "clickhouse query duration (µs)",
                buckets=[50, 200, 1000, 5000, 20000, 100000, 500000],
            )
        except Exception:  # noqa: BLE001
            pass

    def connect(self) -> None:
        factory = self._client_factory
        if factory is None:
            try:
                import clickhouse_connect  # type: ignore[import-not-found]
            except ImportError as e:
                raise DatasourceError(e, "clickhouse-connect not installed; pass client_factory") from e

            def factory(dsn):  # noqa: F811
                return clickhouse_connect.get_client(dsn=dsn)

        self._client = factory(self._dsn)
        if self.logger:
            self.logger.info("connected to clickhouse")

    # -- operations ------------------------------------------------------------

    def _observe(self, stmt: str, start: float) -> None:
        micros = (time.perf_counter() - start) * 1e6
        if self.metrics:
            self.metrics.record_histogram("app_clickhouse_stats", micros)
        if self.logger:
            self.logger.debug({"type": "clickhouse", "query": stmt[:120],
                               "duration_us": round(micros, 1)})

    def _run(self, stmt: str, fn: Callable[[Any], Any]) -> Any:
        if self._client is None:
            raise DatasourceError("clickhouse not connected", "call connect() first")
        start = time.perf_counter()
        try:
            return fn(self._client)
        except DatasourceError:
            raise
        except Exception as e:  # noqa: BLE001
            raise DatasourceError(e, f"clickhouse query failed: {stmt[:120]}") from e
        finally:
            self._observe(stmt, start)

    def exec(self, stmt: str, *params: Any) -> None:
        self._run(stmt, lambda c: c.command(stmt, parameters=params or None))

    def select(self, stmt: str, *params: Any) -> list[dict]:
        def go(c):
            res = c.query(stmt, parameters=params or None)
            cols = res.column_names
            return [dict(zip(cols, row)) for row in res.result_rows]

        return self._run(stmt, go)

    def async_insert(self, table: str, rows: list[dict]) -> None:
        """Fire-and-forget batch insert (`AsyncInsert` parity)."""
        if not rows:
            return
        cols = list(rows[0].keys())

        def go(c):
            c.insert(table, [[r.get(k) for k in cols] for r in rows], column_names=cols)

        self._run(f"INSERT INTO {table}", go)

    def health_check(self) -> dict[str, Any]:
        if self._client is None:
            return {"status": "DOWN", "details": {"error": "not connected"}}
        try:
            self._run("SELECT 1", lambda c: c.command("SELECT 1"))
            return {"status": "UP", "details": {}}
        except Exception as e:  # noqa: BLE001
            return {"status": "DOWN", "details": {"error": str(e)}}


# -- in-tree fake (sqlite-backed so SQL actually executes) ---------------------


class InMemoryClickhouseClient:
    def __init__(self, *_a, **_kw):
        import sqlite3

        self._db = sqlite3.connect(":memory:", check_same_thread=False)

    def command(self, stmt: str, parameters=None):
        cur = self._db.execute(stmt, tuple(parameters or ()))
        self._db.commit()
        return cur.fetchone()

    def query(self, stmt: str, parameters=None):
        cur = self._db.execute(stmt, tuple(parameters or ()))

        class _Res:
            column_names = [d[0] for d in cur.description or []]
            result_rows = cur.fetchall()

        return _Res()

    def insert(self, table: str, rows, column_names):
        ph = ",".join("?" for _ in column_names)
        self._db.executemany(
            f"INSERT INTO {table} ({','.join(column_names)}) VALUES ({ph})", rows
        )
        self._db.commit()


def in_memory_clickhouse() -> Clickhouse:
    return Clickhouse(client_factory=lambda *_: InMemoryClickhouseClient())
