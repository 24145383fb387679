"""KV store: embedded persistent key-value datasource.

Capability parity with the reference's BadgerDB plugin (gofr
`pkg/gofr/datasource/kv-store/badger/`): get/set/delete inside transactions with
an ``app_kv_stats`` histogram per op. Backed by sqlite (stdlib) for durability
without external deps — same WAL-backed embedded-store shape as Badger.

The port's own copy of gofr_tpu/datasource/kv.py.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from typing import Any

from gofr_tpu_torch.datasource import DatasourceError


class KVStore:
    def __init__(self, path: str = ":memory:", logger=None, metrics=None):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v BLOB)")
        self._conn.commit()
        self._logger = logger
        self._metrics = metrics
        self._lock = threading.Lock()
        self.path = path

    def _observe(self, op: str, start: float) -> None:
        if self._metrics is not None:
            self._metrics.record_histogram("app_kv_stats", time.perf_counter() - start, op=op)

    def get(self, key: str) -> bytes | None:
        start = time.perf_counter()
        with self._lock:
            row = self._conn.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        self._observe("get", start)
        return row[0] if row else None

    def set(self, key: str, value: Any) -> None:
        data = value if isinstance(value, bytes) else str(value).encode()
        start = time.perf_counter()
        with self._lock:
            try:
                self._conn.execute(
                    "INSERT INTO kv (k, v) VALUES (?, ?) ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                    (key, data),
                )
                self._conn.commit()
            except sqlite3.Error as e:
                self._conn.rollback()
                raise DatasourceError(e) from e
        self._observe("set", start)

    def delete(self, key: str) -> None:
        start = time.perf_counter()
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._conn.commit()
        self._observe("delete", start)

    def keys(self) -> list[str]:
        with self._lock:
            return [r[0] for r in self._conn.execute("SELECT k FROM kv ORDER BY k").fetchall()]

    def health_check(self) -> dict[str, Any]:
        try:
            with self._lock:
                self._conn.execute("SELECT 1")
            return {"status": "UP", "details": {"path": self.path}}
        except Exception as e:  # noqa: BLE001
            return {"status": "DOWN", "details": {"path": self.path, "error": str(e)}}

    def close(self) -> None:
        with self._lock:
            self._conn.close()
