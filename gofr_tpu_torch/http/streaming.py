"""Streaming responses: SSE over HTTP and token frames over a websocket
(the port's own copy of gofr_tpu/http/streaming.py; the raw passthrough
waits with the router).

A handler returns ``StreamingResponse(engine-or-ctx stream iterator)``. On
an HTTP route the app drives it as ``text/event-stream``: one ``data:
<json>`` event per item, then a terminal ``event: done`` (or ``event:
error``) frame; on a websocket route one text frame per item
(``encode_ws``), then ``{"done": true}``. The bytes of every frame are the
JAX package's.

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

    def encode_ws(self, item: Any) -> str:
        """Every frame is JSON: data items encode to JSON values (a text
        piece arrives as a JSON string, a token id as a number), and the
        terminal control frame is the object ``{"done": true}`` — a
        streamed piece whose TEXT is '{"done": true}' encodes to a JSON
        string and stays unambiguously data."""
        return json.dumps(item)
