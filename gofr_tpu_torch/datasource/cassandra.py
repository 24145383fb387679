"""Cassandra datasource plugin (gofr `pkg/gofr/datasource/cassandra/`,
separate-module tier — SURVEY.md §2.4).

The session is reached through an injectable ``session_factory`` (the
reference hides gocql behind `clusterConfig/session/query` interfaces for
exactly this mockability, `cassandra.go:22-26`); ``InMemorySession`` is an
in-tree fake good enough for CRUD-shaped statements. Row binding into
dataclass/dict targets mirrors the reference's reflection row-binding
(`cassandra.go:87-`); ``exec_cas`` is the lightweight-transaction analog.
``app_cassandra_stats`` histogram per query (`cassandra.go:63-64`).

The port's own copy of gofr_tpu/datasource/cassandra.py.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Callable

from gofr_tpu_torch.datasource import DatasourceError


class Cassandra:
    def __init__(
        self,
        hosts: str | None = None,
        keyspace: str = "test",
        session_factory: Callable[..., Any] | None = None,
    ):
        self._hosts = (hosts or "localhost").split(",")
        self._keyspace = keyspace
        self._session_factory = session_factory
        self._session = None
        self.logger = None
        self.metrics = None

    # -- provider lifecycle ----------------------------------------------------

    def use_logger(self, logger) -> None:
        self.logger = logger

    def use_metrics(self, metrics) -> None:
        self.metrics = metrics
        try:
            metrics.new_histogram(
                "app_cassandra_stats", "cassandra query duration (µs)",
                buckets=[50, 200, 1000, 5000, 20000, 100000, 500000],
            )
        except Exception:  # noqa: BLE001
            pass

    def connect(self) -> None:
        factory = self._session_factory
        if factory is None:
            try:
                from cassandra.cluster import Cluster  # type: ignore[import-not-found]
            except ImportError as e:
                raise DatasourceError(e, "cassandra-driver not installed; pass session_factory") from e

            def factory(hosts, keyspace):  # noqa: F811
                return Cluster(hosts).connect(keyspace)

        self._session = factory(self._hosts, self._keyspace)
        if self.logger:
            self.logger.info(f"connected to cassandra keyspace {self._keyspace!r}")

    # -- operations ------------------------------------------------------------

    def _observe(self, stmt: str, start: float) -> None:
        micros = (time.perf_counter() - start) * 1e6
        if self.metrics:
            self.metrics.record_histogram("app_cassandra_stats", micros)
        if self.logger:
            self.logger.debug({"type": "cassandra", "query": stmt[:120],
                               "duration_us": round(micros, 1)})

    def _execute(self, stmt: str, params: tuple = ()) -> Any:
        if self._session is None:
            raise DatasourceError("cassandra not connected", "call connect() first")
        start = time.perf_counter()
        try:
            return self._session.execute(stmt, params)
        except DatasourceError:
            raise
        except Exception as e:  # noqa: BLE001
            raise DatasourceError(e, f"cassandra query failed: {stmt[:120]}") from e
        finally:
            self._observe(stmt, start)

    def exec(self, stmt: str, *params: Any) -> None:
        self._execute(stmt, params)

    def query(self, target: Any, stmt: str, *params: Any) -> Any:
        """Rows bound into ``target``: dict → list[dict]; a dataclass type →
        list of instances (reference reflection-binding parity)."""
        rows = self._execute(stmt, params)
        out = [self._bind_row(r, target) for r in rows]
        return out

    def query_one(self, target: Any, stmt: str, *params: Any) -> Any:
        rows = self.query(target, stmt, *params)
        return rows[0] if rows else None

    def exec_cas(self, stmt: str, *params: Any) -> bool:
        """Lightweight transaction (IF ...): True when applied."""
        rows = self._execute(stmt, params)
        try:
            first = next(iter(rows))
        except StopIteration:
            return True
        if isinstance(first, dict):
            return bool(first.get("[applied]", True))
        return bool(getattr(first, "applied", True))

    @staticmethod
    def _bind_row(row: Any, target: Any):
        as_dict = dict(row) if isinstance(row, dict) else (
            row._asdict() if hasattr(row, "_asdict") else dict(vars(row))
        )
        if target is dict:
            return as_dict
        if dataclasses.is_dataclass(target):
            names = {f.name for f in dataclasses.fields(target)}
            return target(**{k: v for k, v in as_dict.items() if k in names})
        raise DatasourceError(f"unsupported bind target {target!r}", "use dict or a dataclass")

    def health_check(self) -> dict[str, Any]:
        if self._session is None:
            return {"status": "DOWN", "details": {"error": "not connected"}}
        try:
            self._execute("SELECT release_version FROM system.local")
            return {"status": "UP", "details": {"keyspace": self._keyspace}}
        except Exception as e:  # noqa: BLE001
            return {"status": "DOWN", "details": {"error": str(e)}}


# -- in-tree fake --------------------------------------------------------------


class InMemorySession:
    """CRUD-shaped CQL fake for hermetic tests: supports
    CREATE TABLE / INSERT INTO ... VALUES / SELECT [cols|*] FROM ... [WHERE k=?]
    / DELETE FROM ... WHERE / SELECT release_version FROM system.local."""

    def __init__(self, *_a, **_kw):
        self._tables: dict[str, list[dict]] = {}
        self._columns: dict[str, list[str]] = {}

    def execute(self, stmt: str, params: tuple = ()):  # noqa: C901
        s = stmt.strip().rstrip(";")
        low = s.lower()
        if low.startswith("select release_version from system.local"):
            return [{"release_version": "in-memory"}]
        m = re.match(r"create table (?:if not exists )?(\w+)\s*\((.*)\)", low, re.S)
        if m:
            cols = [c.strip().split()[0] for c in m.group(2).split(",") if c.strip()]
            self._tables.setdefault(m.group(1), [])
            self._columns[m.group(1)] = [c for c in cols if c != "primary"]
            return []
        m = re.match(r"insert into (\w+)\s*\(([^)]*)\)\s*values\s*\(([^)]*)\)(\s+if not exists)?", low)
        if m:
            table, cols = m.group(1), [c.strip() for c in m.group(2).split(",")]
            row = dict(zip(cols, params))
            rows = self._tables.setdefault(table, [])
            if m.group(4):  # IF NOT EXISTS on first column as key
                key = cols[0]
                if any(r.get(key) == row.get(key) for r in rows):
                    return [{"[applied]": False}]
                rows.append(row)
                return [{"[applied]": True}]
            rows.append(row)
            return []
        m = re.match(r"select (.*) from (\w+)(?:\s+where\s+(\w+)\s*=\s*\?)?(?:\s+allow filtering)?$", low)
        if m:
            cols_s, table, where = m.groups()
            rows = self._tables.get(table, [])
            if where:
                rows = [r for r in rows if r.get(where) == params[0]]
            if cols_s.strip() == "*":
                return [dict(r) for r in rows]
            want = [c.strip() for c in cols_s.split(",")]
            return [{c: r.get(c) for c in want} for r in rows]
        m = re.match(r"delete from (\w+)\s+where\s+(\w+)\s*=\s*\?", low)
        if m:
            table, col = m.groups()
            rows = self._tables.get(table, [])
            self._tables[table] = [r for r in rows if r.get(col) != params[0]]
            return []
        raise ValueError(f"InMemorySession cannot parse: {stmt!r}")


def in_memory_cassandra(keyspace: str = "test") -> Cassandra:
    return Cassandra(keyspace=keyspace, session_factory=lambda *_: InMemorySession())
