"""Redis datasource: dependency-free RESP2 client with command logging + metrics.

Parity with gofr `pkg/gofr/datasource/redis/`: config from ``REDIS_HOST/PORT``,
5s ping timeout on connect (`redis.go:16-19,47-55`; a host that does not
answer raises at boot, where JAX's logs it and leaves Redis unwired:
ROADMAP.md Queue C), and every command logged
with µs duration + recorded in ``app_redis_stats`` (`hook.go:17-50`). The wire
protocol is implemented directly (redis-py is not a baked-in dependency), with
pipelining support.

The port's own copy of gofr_tpu/datasource/redis.py.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any

from gofr_tpu_torch.datasource import DatasourceError


class RESPConnection:
    def __init__(self, host: str, port: int, timeout: float = 5.0, db: int = 0, password: str | None = None):
        self.host, self.port = host, port
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""
        if password:
            self._roundtrip([b"AUTH", password.encode()])
        if db:
            self._roundtrip([b"SELECT", str(db).encode()])

    def _encode(self, parts: list[bytes]) -> bytes:
        out = [b"*%d\r\n" % len(parts)]
        for p in parts:
            out.append(b"$%d\r\n%s\r\n" % (len(p), p))
        return b"".join(out)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2 :]
        return data

    def _read_reply(self) -> Any:
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise DatasourceError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            return self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise DatasourceError(f"unexpected RESP reply type {line!r}")

    def _roundtrip(self, parts: list[bytes]) -> Any:
        self._sock.sendall(self._encode(parts))
        return self._read_reply()

    def send(self, parts: list[bytes]) -> None:
        self._sock.sendall(self._encode(parts))

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _to_bytes(v: Any) -> bytes:
    if isinstance(v, bytes):
        return v
    return str(v).encode()


class Redis:
    """Command API over one connection (thread-safe via lock)."""

    def __init__(self, conn: RESPConnection, logger=None, metrics=None):
        self._conn = conn
        self._logger = logger
        self._metrics = metrics
        self._lock = threading.Lock()

    def command(self, *args: Any) -> Any:
        parts = [_to_bytes(a) for a in args]
        start = time.perf_counter()
        with self._lock:
            result = self._conn._roundtrip(parts)
        dur = time.perf_counter() - start
        if self._metrics is not None:
            self._metrics.record_histogram("app_redis_stats", dur, command=str(args[0]).upper())
        if self._logger is not None:
            self._logger.debug({"message": "redis", "command": str(args[0]).upper(), "duration_us": int(dur * 1e6)})
        return result

    # common command sugar
    def ping(self) -> bool:
        return self.command("PING") == "PONG"

    def get(self, key: str) -> bytes | None:
        return self.command("GET", key)

    def set(self, key: str, value: Any, ex: int | None = None) -> bool:
        args: list[Any] = ["SET", key, value]
        if ex is not None:
            args += ["EX", ex]
        return self.command(*args) == "OK"

    def delete(self, *keys: str) -> int:
        return self.command("DEL", *keys)

    def incr(self, key: str) -> int:
        return self.command("INCR", key)

    def expire(self, key: str, seconds: int) -> int:
        return self.command("EXPIRE", key, seconds)

    def ttl(self, key: str) -> int:
        return self.command("TTL", key)

    def hset(self, key: str, field: str, value: Any) -> int:
        return self.command("HSET", key, field, value)

    def hget(self, key: str, field: str) -> bytes | None:
        return self.command("HGET", key, field)

    def hgetall(self, key: str) -> dict[str, bytes]:
        flat = self.command("HGETALL", key) or []
        return {flat[i].decode(): flat[i + 1] for i in range(0, len(flat), 2)}

    def lpush(self, key: str, *values: Any) -> int:
        return self.command("LPUSH", key, *values)

    def rpop(self, key: str) -> bytes | None:
        return self.command("RPOP", key)

    def keys(self, pattern: str = "*") -> list[bytes]:
        return self.command("KEYS", pattern) or []

    def pipeline(self) -> "Pipeline":
        return Pipeline(self)

    def health_check(self) -> dict[str, Any]:
        try:
            ok = self.ping()
            return {"status": "UP" if ok else "DOWN", "details": {"host": self._conn.host}}
        except Exception as e:  # noqa: BLE001
            return {"status": "DOWN", "details": {"host": self._conn.host, "error": str(e)}}

    def close(self) -> None:
        self._conn.close()


class Pipeline:
    """Batched commands in one roundtrip (logged as one pipeline op)."""

    def __init__(self, redis: Redis):
        self._redis = redis
        self._commands: list[list[bytes]] = []

    def command(self, *args: Any) -> "Pipeline":
        self._commands.append([_to_bytes(a) for a in args])
        return self

    def set(self, key: str, value: Any) -> "Pipeline":
        return self.command("SET", key, value)

    def get(self, key: str) -> "Pipeline":
        return self.command("GET", key)

    def execute(self) -> list[Any]:
        if not self._commands:
            return []
        start = time.perf_counter()
        r = self._redis
        with r._lock:
            for parts in self._commands:
                r._conn.send(parts)
            # drain EVERY reply even on error replies — leaving replies buffered
            # would desync the connection for all later commands
            results: list[Any] = []
            first_error: DatasourceError | None = None
            for _ in self._commands:
                try:
                    results.append(r._conn._read_reply())
                except DatasourceError as e:
                    results.append(e)
                    if first_error is None:
                        first_error = e
        dur = time.perf_counter() - start
        if r._metrics is not None:
            r._metrics.record_histogram("app_redis_stats", dur, command="PIPELINE")
        if r._logger is not None:
            r._logger.debug({"message": "redis pipeline", "commands": len(self._commands), "duration_us": int(dur * 1e6)})
        self._commands = []
        if first_error is not None:
            raise first_error
        return results


def connect_redis(config, logger, metrics) -> Redis | None:
    host = config.get("REDIS_HOST")
    if not host:
        return None
    port = config.get_int("REDIS_PORT", 6379)
    try:
        conn = RESPConnection(
            host, port,
            timeout=config.get_float("REDIS_TIMEOUT", 5.0),
            db=config.get_int("REDIS_DB", 0),
            password=config.get("REDIS_PASSWORD"),
        )
        client = Redis(conn, logger, metrics)
        client.ping()
        logger.infof("connected to redis at %s:%d", host, port)
        return client
    except Exception as e:  # noqa: BLE001
        raise DatasourceError(e, f"could not connect to redis at {host}:{port}: {e}") from e
