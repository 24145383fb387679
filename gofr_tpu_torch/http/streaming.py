"""Streaming responses: SSE over HTTP (the port's own copy of the SSE part of
gofr_tpu/http/streaming.py; the websocket frames and the raw passthrough
wait with the websocket route and the router).

A handler returns ``StreamingResponse(engine-or-ctx stream iterator)`` and
the app drives it as ``text/event-stream``: one ``data: <json>`` event per
item, then a terminal ``event: done`` (or ``event: error``) frame. The
bytes of every frame are the JAX package's.

The iterator may block (the engine's stream queue does), so the app pulls
items on the handler executor, never on the event loop.
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Iterator


class StreamingResponse:
    """Wraps a (possibly blocking) iterator of items for incremental
    delivery. ``event`` names the SSE event type for data frames."""

    def __init__(self, iterator: Iterable[Any], *, event: str | None = None):
        self.iterator: Iterator[Any] = iter(iterator)
        self.event = event

    def encode_sse(self, item: Any) -> bytes:
        prefix = f"event: {self.event}\n" if self.event else ""
        return f"{prefix}data: {json.dumps(item)}\n\n".encode()

    @staticmethod
    def sse_done() -> bytes:
        return b"event: done\ndata: {}\n\n"

    @staticmethod
    def sse_error(message: str) -> bytes:
        return f"event: error\ndata: {json.dumps({'message': message})}\n\n".encode()
