"""Versioned migrations (gofr `pkg/gofr/migration/`).

User supplies ``{version:int -> Migration(up=fn)}``; the runner sorts versions,
skips those at or below the last applied, wraps each in per-datasource
transactions, records completions per datasource, and rolls back on failure
(`migration.go:28-91`). The datasource handle passed to ``up`` exposes
sql/redis/kv/pubsub so migrations can touch any wired store
(chain-of-responsibility per `interface.go:44-51`):

- **SQL**: statements run inside a real transaction; the completion row in
  ``gofr_migrations`` commits with the migration's own writes (`sql.go:12-18`).
- **Redis**: the handle is a BUFFERING transaction view (``RedisTx``) — the
  reference swaps ``ds.Redis`` for a ``TxPipeline`` the same way
  (`migration.go:69-71`, `redis.go:78-127`). Writes queue locally and are
  shipped as one MULTI/EXEC at commit together with the completion record in
  the ``gofr_migrations`` hash; a failing migration discards the buffer, so
  no partial Redis state survives. Reads pass through to the live client and
  see pre-transaction state (MULTI semantics: queued writes are not readable
  before EXEC).
- **Pub/Sub**: ``d.pubsub.create_topic``/``delete_topic`` for topic
  migrations (`interface.go:28-31`); brokers offer no transactions, so these
  apply immediately — order topic creates FIRST in a migration.
- Completion bookkeeping lives in EVERY wired transactional datasource; the
  skip point is the max across them (`redis.go:34-76` getLastMigration).

The port's own copy of gofr_tpu/migration/__init__.py.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class Migration:
    up: Callable[["MigrationDatasource"], Any]


class RedisTx:
    """Buffered Redis view handed to migrations: write commands queue and
    execute atomically (MULTI/EXEC in one pipeline) at commit; reads pass
    through to the live client."""

    def __init__(self, redis):
        self._redis = redis
        self._buffer: list[tuple[Any, ...]] = []

    # -- buffered writes -------------------------------------------------------

    def command(self, *args: Any) -> "RedisTx":
        self._buffer.append(args)
        return self

    def set(self, key: str, value: Any, ex: int | None = None) -> "RedisTx":
        return self.command(*(("SET", key, value) + (("EX", ex) if ex is not None else ())))

    def delete(self, *keys: str) -> "RedisTx":
        return self.command("DEL", *keys)

    def hset(self, key: str, field: str, value: Any) -> "RedisTx":
        return self.command("HSET", key, field, value)

    def lpush(self, key: str, *values: Any) -> "RedisTx":
        return self.command("LPUSH", key, *values)

    def incr(self, key: str) -> "RedisTx":
        return self.command("INCR", key)

    def expire(self, key: str, seconds: int) -> "RedisTx":
        return self.command("EXPIRE", key, seconds)

    # -- passthrough reads (pre-transaction state) -----------------------------

    def get(self, key: str):
        return self._redis.get(key)

    def hget(self, key: str, field: str):
        return self._redis.hget(key, field)

    def hgetall(self, key: str):
        return self._redis.hgetall(key)

    def keys(self, pattern: str = "*"):
        return self._redis.keys(pattern)

    # -- lifecycle (runner-only) -----------------------------------------------

    def _commit(self) -> None:
        if not self._buffer:
            return
        pipe = self._redis.pipeline()
        pipe.command("MULTI")
        for parts in self._buffer:
            pipe.command(*parts)
        pipe.command("EXEC")
        pipe.execute()
        self._buffer = []

    def _discard(self) -> None:
        self._buffer = []


class MigrationDatasource:
    """Narrow view of the container handed to each migration."""

    def __init__(self, container, tx=None, redis=None):
        self._container = container
        self.sql = tx if tx is not None else container.sql
        self.redis = redis if redis is not None else container.redis
        self.kv = container.kv
        self.pubsub = container.pubsub
        self.logger = container.logger


MIGRATION_TABLE_DDL = (
    "CREATE TABLE IF NOT EXISTS gofr_migrations ("
    "version INTEGER PRIMARY KEY, method TEXT, start_time TEXT, duration_ms INTEGER)"
)
REDIS_MIGRATION_KEY = "gofr_migrations"


def _last_applied(db, redis) -> int:
    last = 0
    if db is not None:
        row = db.query_row("SELECT MAX(version) AS v FROM gofr_migrations")
        if row and row["v"] is not None:
            last = int(row["v"])
    if redis is not None:
        for key in redis.hgetall(REDIS_MIGRATION_KEY):
            k = key.decode() if isinstance(key, bytes) else str(key)
            try:
                last = max(last, int(k))
            except ValueError:
                continue
    return last


def run_migrations(migrations: dict[int, Migration | Any], container) -> list[int]:
    """Run pending migrations in version order; returns versions applied."""
    logger = container.logger
    if not migrations:
        return []
    db = container.sql
    redis = container.redis
    if db is None and redis is None:
        raise RuntimeError(
            "migrations require a transactional datasource (set DB_DIALECT or REDIS_HOST)"
        )

    if db is not None:
        db.execute(MIGRATION_TABLE_DDL)
        # a version recorded as redis-pending means a previous run
        # committed SQL but died before (or during) the Redis EXEC: its
        # Redis writes were NEVER applied, and because the skip point is
        # the max across datasources a silent rerun would skip them
        # forever. Refuse to proceed until the operator replays the
        # migration's Redis writes and clears the marker
        # (UPDATE gofr_migrations SET method='UP' WHERE version=N) —
        # docs/migrations.md#redis-pending.
        row = db.query_row(
            "SELECT version FROM gofr_migrations WHERE method = 'UP:redis-pending'"
        )
        if row and row.get("version") is not None:
            raise RuntimeError(
                f"migration {row['version']} is marked UP:redis-pending (SQL "
                "committed, Redis EXEC unconfirmed). Check Redis first: "
                f"HGET gofr_migrations {row['version']} — if the completion "
                "record EXISTS the EXEC succeeded and only the marker-clear "
                "failed (do NOT replay; just clear the marker); if ABSENT, "
                "replay the migration's Redis writes manually. Then clear: "
                f"UPDATE gofr_migrations SET method='UP' WHERE "
                f"version={row['version']} (docs/migrations.md#redis-pending)"
            )
    last = _last_applied(db, redis)

    applied: list[int] = []
    for version in sorted(migrations):
        if version <= last:
            continue
        migration = migrations[version]
        up = migration.up if isinstance(migration, Migration) else migration
        start = time.time()
        tx = db.begin().__enter__() if db is not None else None
        redis_tx = RedisTx(redis) if redis is not None else None
        try:
            up(MigrationDatasource(container, tx=tx, redis=redis_tx))
            duration_ms = int((time.time() - start) * 1000)
            stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(start))
            # Commit order: SQL FIRST, then the Redis EXEC. The skip point
            # is the max across datasources, so whichever commits last must
            # be the one that can't fail for data-dependent reasons — SQL
            # (DDL conflicts, constraints) fails far more often than an
            # EXEC of already-validated commands. An SQL failure here rolls
            # everything back cleanly; a Redis failure after the SQL commit
            # leaves SQL recorded and is surfaced loudly below.
            if tx is not None:
                # with Redis also in play, the version commits as
                # 'UP:redis-pending' and flips to 'UP' only after the EXEC
                # confirms — a crash in the window leaves a durable marker
                # that run_migrations refuses to skip past
                # (docs/migrations.md#redis-pending)
                method = "UP:redis-pending" if redis_tx is not None else "UP"
                tx.execute(
                    "INSERT INTO gofr_migrations (version, method, start_time, duration_ms) VALUES (?, ?, ?, ?)",
                    (version, method, stamp, duration_ms),
                )
                tx.commit()
            if redis_tx is not None:
                # completion record rides the same MULTI/EXEC as the
                # migration's own writes (redis.go:90-119)
                redis_tx.hset(REDIS_MIGRATION_KEY, str(version), json.dumps(
                    {"method": "UP", "startTime": stamp, "duration": duration_ms}))
                try:
                    redis_tx._commit()
                except Exception:
                    if tx is not None:
                        logger.errorf(
                            "migration %d: SQL committed but the Redis EXEC failed — "
                            "Redis writes for this version were NOT applied; the "
                            "version stays marked UP:redis-pending and the next "
                            "run_migrations will refuse to start until it is "
                            "replayed and cleared (docs/migrations.md#redis-pending)",
                            version,
                        )
                    raise
                if tx is not None:
                    # EXEC confirmed: clear the pending marker. A failure
                    # RIGHT HERE must not read as a failed migration — the
                    # writes are fully applied; the stale marker is a
                    # safe-side false positive (the refusal message tells
                    # the operator how to distinguish it via HGET).
                    try:
                        db.execute(
                            "UPDATE gofr_migrations SET method = 'UP' WHERE version = ?",
                            (version,),
                        )
                    except Exception as clear_err:  # noqa: BLE001
                        logger.errorf(
                            "migration %d: Redis EXEC CONFIRMED but clearing the "
                            "redis-pending marker failed (%r). Do NOT replay — "
                            "just clear the marker: UPDATE gofr_migrations SET "
                            "method='UP' WHERE version=%d",
                            version, clear_err, version,
                        )
        except Exception as e:  # noqa: BLE001
            if redis_tx is not None:
                redis_tx._discard()
            if tx is not None:
                tx.rollback()
            logger.errorf("migration %d failed, rolled back: %r", version, e)
            raise
        finally:
            if tx is not None:
                tx.__exit__(None, None, None)
        logger.infof("migration %d applied in %dms", version, int((time.time() - start) * 1000))
        applied.append(version)
    return applied
