"""WebSocket support: per-message handler loop + thread-safe connection hub.

Parity with gofr `pkg/gofr/websocket.go` + `pkg/gofr/websocket/`: a route
upgrades, the user handler runs once per received message with a Context whose
``bind`` reads that message (`websocket/websocket.go:63-77`), the return value
is written back, and live connections are tracked in a hub keyed by connection
id (`websocket/websocket.go:88-137`) for server-push broadcast.

The port's own copy of gofr_tpu/websocket.py; the sessions are
``http/server.py``'s ``WebSocket`` (RFC 6455 on the standard library) where
the JAX App's are aiohttp's.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Any

from gofr_tpu_torch.utils import bind as binder


class WSConnection:
    """Request implementation over a single received websocket message."""

    def __init__(self, conn_id: str, ws, message: str | bytes, loop: asyncio.AbstractEventLoop):
        self.conn_id = conn_id
        self._ws = ws
        self._message = message
        self._loop = loop
        self._ctx: dict[str, Any] = {}

    # -- Request interface -----------------------------------------------------

    def param(self, key: str) -> str:
        return ""

    def params(self, key: str) -> list[str]:
        return []

    def path_param(self, key: str) -> str:
        return ""

    def bind(self, target: Any = dict) -> Any:
        raw = self._message if isinstance(self._message, bytes) else self._message.encode()
        if target is bytes:
            return raw
        if target is str:
            return raw.decode()
        try:
            data = json.loads(raw)
        except json.JSONDecodeError as e:
            raise binder.BindError("websocket message is not JSON") from e
        return binder.bind(data, target)

    def host_name(self) -> str:
        return "websocket"

    def context(self) -> dict[str, Any]:
        return self._ctx

    # -- push (safe from any thread) ------------------------------------------

    def send(self, data: Any) -> None:
        payload = data if isinstance(data, str) else json.dumps(data, default=str)
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self._loop:
            # called from an async handler on the serving loop: blocking here
            # would deadlock — schedule the send instead
            self._loop.create_task(self._ws.send_str(payload))
        else:
            asyncio.run_coroutine_threadsafe(self._ws.send_str(payload), self._loop).result(timeout=30)


class ConnectionHub:
    """Thread-safe registry of live websocket connections."""

    def __init__(self):
        self._conns: dict[str, Any] = {}
        self._lock = threading.Lock()

    def add(self, conn_id: str, ws) -> None:
        with self._lock:
            self._conns[conn_id] = ws

    def remove(self, conn_id: str) -> None:
        with self._lock:
            self._conns.pop(conn_id, None)

    def get(self, conn_id: str):
        with self._lock:
            return self._conns.get(conn_id)

    def ids(self) -> list[str]:
        with self._lock:
            return list(self._conns)

    def __len__(self) -> int:
        with self._lock:
            return len(self._conns)

    async def broadcast(self, data: Any) -> int:
        payload = data if isinstance(data, str) else json.dumps(data, default=str)
        with self._lock:
            conns = list(self._conns.values())
        sent = 0
        for ws in conns:
            try:
                await ws.send_str(payload)
                sent += 1
            except Exception:  # noqa: BLE001 - dead conns are reaped by their own loop
                pass
        return sent
