"""An HTTP/1.1 server on the standard library, for the port's App (the JAX
``App`` serves through aiohttp, gofr_tpu/app.py:25; the port keeps to what
the card's installation has).

``HTTPServer`` listens with ``asyncio.start_server`` and speaks just enough
HTTP/1.1 for a JSON API and server-sent events:

- a request is its request line, its headers and a body of
  ``Content-Length`` bytes; ``Expect: 100-continue`` is answered (curl
  sends it on larger bodies); a chunked request body gets 411, a body past
  ``max_body`` 413, a malformed request 400;
- a response carries ``Content-Length``, or is streamed with chunked
  transfer (``ServerRequest.prepare_stream``), each chunk flushed as it is
  written and no ``Content-Length`` sent;
- every response says ``Connection: close`` and the connection closes after
  it (no keep-alive);
- ``Router`` matches a method and a path template whose segments may be
  ``{name}`` parameters (``ServerRequest.path_params``); an unmatched
  request goes to the router's fallback.

A middleware is ``async def mw(request, handler) -> ServerResponse``; the
first in the list is the outermost, as in aiohttp. A streamed response is
written by the handler itself, so a middleware sees it only after the
stream has ended. A write to a client that went away raises
``ConnectionResetError``, which is how a streaming handler learns to cancel
the work behind it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import re
import time
from http import HTTPStatus
from typing import Any, Awaitable, Callable
from urllib.parse import unquote

Handler = Callable[["ServerRequest"], Awaitable["ServerResponse"]]
Middleware = Callable[["ServerRequest", Handler], Awaitable["ServerResponse"]]

MAX_LINE = 16 * 1024
MAX_HEADERS = 128


class BadRequest(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


@dataclasses.dataclass
class ServerResponse:
    """A whole response, or (``streamed``) the record of one the handler
    already wrote through ``prepare_stream``."""

    status: int = 200
    body: bytes = b""
    content_type: str | None = "application/json"
    headers: dict[str, str] = dataclasses.field(default_factory=dict)
    streamed: bool = False


class ChunkedStream:
    """The body of a streamed response, in chunked transfer encoding."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._reader, self._writer = reader, writer

    def _check(self) -> None:
        # the client's FIN shows as EOF on the request side: nobody reads on
        if self._writer.is_closing() or self._reader.at_eof():
            raise ConnectionResetError("client closed the connection")

    async def write(self, data: bytes) -> None:
        if not data:
            return
        self._check()
        self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
        await self._writer.drain()

    async def write_eof(self) -> None:
        self._check()
        self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()


class ServerRequest:
    """One parsed request. ``path`` is percent-decoded; ``headers`` maps
    lower-cased names to values (``raw_headers`` keeps the wire's names);
    ``route_template`` and ``path_params`` are the matched route's.
    ``accepted_at`` and ``read_at`` are the monotonic times the server
    accepted the connection and had read the whole request. ``state``
    carries what a middleware hands the layers inside it (the server span,
    the QoS class)."""

    def __init__(self, method: str, target: str, raw_headers: list[tuple[str, str]], body: bytes,
                 remote: str, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 accepted_at: float):
        self.method = method
        path, _, self.query_string = target.partition("?")
        self.path = unquote(path)
        self.raw_headers = raw_headers
        self.headers = {k.lower(): v for k, v in raw_headers}
        self.body = body
        self.remote = remote
        self.route_template = self.path
        self.path_params: dict[str, str] = {}
        self._reader, self._writer = reader, writer
        self.stream: ChunkedStream | None = None
        self.accepted_at, self.read_at = accepted_at, time.monotonic()
        self.state: dict[str, Any] = {}

    @property
    def path_qs(self) -> str:
        return f"{self.path}?{self.query_string}" if self.query_string else self.path

    async def prepare_stream(self, status: int, headers: dict[str, str]) -> ChunkedStream:
        """Send the status line and headers of a chunked response; the
        returned stream writes its body."""
        head = {**headers, "Transfer-Encoding": "chunked"}
        self._writer.write(_head(status, head))
        await self._writer.drain()
        self.stream = ChunkedStream(self._reader, self._writer)
        return self.stream


def _head(status: int, headers: dict[str, str]) -> bytes:
    try:
        reason = HTTPStatus(status).phrase
    except ValueError:
        reason = "Unknown"
    lines = [f"HTTP/1.1 {status} {reason}"]
    lines += [f"{k}: {v}" for k, v in headers.items() if k.lower() != "connection"]
    lines.append("Connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def _wire(resp: ServerResponse, method: str) -> bytes:
    headers = dict(resp.headers)
    if resp.content_type and not any(k.lower() == "content-type" for k in headers):
        headers["Content-Type"] = resp.content_type
    bodiless = resp.status in (204, 304) or resp.status < 200
    if not bodiless:
        headers["Content-Length"] = str(len(resp.body))
    body = b"" if bodiless or method == "HEAD" else resp.body
    return _head(resp.status, headers) + body


class Router:
    """Routes by method and path template. A template segment ``{name}``
    matches one path segment. The first route registered for a (method,
    path) wins; a request no route matches goes to ``fallback`` with
    ``fallback_template``."""

    _PARAM = re.compile(r"\{(\w+)\}")

    def __init__(self, fallback: Handler, fallback_template: str = "/{tail}"):
        self._routes: list[tuple[str, re.Pattern, str, Handler]] = []
        self.fallback, self.fallback_template = fallback, fallback_template

    def add(self, method: str, template: str, handler: Handler) -> None:
        pattern, pos = "", 0
        for m in self._PARAM.finditer(template):
            pattern += re.escape(template[pos:m.start()])
            pattern += f"(?P<{m.group(1)}>[^/]+)"
            pos = m.end()
        pattern += re.escape(template[pos:])
        self._routes.append((method.upper(), re.compile(f"^{pattern}$"), template, handler))

    def resolve(self, request: ServerRequest) -> Handler:
        for method, pattern, template, handler in self._routes:
            if method != request.method:
                continue
            m = pattern.match(request.path)
            if m:
                request.route_template, request.path_params = template, m.groupdict()
                return handler
        request.route_template = self.fallback_template
        return self.fallback


def chain(middlewares: list[Middleware], handler: Handler) -> Handler:
    """``handler`` behind ``middlewares``, the first outermost."""
    for mw in reversed(middlewares):
        handler = (lambda m, h: lambda req: m(req, h))(mw, handler)
    return handler


class HTTPServer:
    """Serves ``router`` behind ``middlewares`` on one port. ``start``
    binds it (port 0 picks a free one; ``port`` then reads it), ``close``
    stops listening, waits up to ``grace`` seconds for open connections and
    cancels the rest."""

    def __init__(self, router: Router, middlewares: list[Middleware] | None = None, *,
                 max_body: int = 64 * 1024 * 1024, on_error: Callable[[BaseException], Any] | None = None):
        self.router = router
        self.middlewares = list(middlewares or [])
        self.max_body = max_body
        self.on_error = on_error
        self.port: int | None = None
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.Task] = set()

    async def start(self, host: str = "0.0.0.0", port: int = 0) -> None:
        self._server = await asyncio.start_server(self._client, host, port, limit=MAX_LINE * 4)
        self.port = self._server.sockets[0].getsockname()[1]

    async def close(self, grace: float = 5.0) -> None:
        if self._server is None:
            return
        self._server.close()
        conns = [t for t in self._conns if not t.done()]
        if conns:
            _, pending = await asyncio.wait(conns, timeout=grace)
            for t in pending:
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)
        self._server = None

    async def _client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await self._serve_one(reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away
        except Exception as e:  # noqa: BLE001 - one connection must not stop the server
            if self.on_error is not None:
                self.on_error(e)
        finally:
            self._conns.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _serve_one(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        accepted_at = time.monotonic()
        peer = writer.get_extra_info("peername")
        remote = peer[0] if isinstance(peer, tuple) else ""
        try:
            request = await self._read_request(reader, writer, remote, accepted_at)
        except BadRequest as e:
            writer.write(_wire(ServerResponse(e.status, _error_body(str(e))), "GET"))
            await writer.drain()
            return
        if request is None:
            return
        handler = chain(self.middlewares, self.router.resolve(request))
        try:
            resp = await handler(request)
        except ConnectionError:
            raise  # the client went away: nobody to answer
        except Exception as e:  # noqa: BLE001 - a handler's fault is the client's 500
            if self.on_error is not None:
                self.on_error(e)
            if request.stream is not None:
                return  # the status line is on the wire already
            resp = ServerResponse(500, _error_body("some unexpected error has occurred"))
        if not resp.streamed:
            writer.write(_wire(resp, request.method))
            await writer.drain()

    async def _read_request(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                            remote: str, accepted_at: float) -> ServerRequest | None:
        line = await _read_line(reader)
        if not line:
            return None  # closed before a request
        parts = line.split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise BadRequest(400, "malformed request line")
        method, target, _ = parts
        raw_headers: list[tuple[str, str]] = []
        while True:
            line = await _read_line(reader)
            if not line:
                break
            if len(raw_headers) >= MAX_HEADERS:
                raise BadRequest(431, "too many headers")
            name, sep, value = line.partition(":")
            if not sep or not name.strip():
                raise BadRequest(400, "malformed header")
            raw_headers.append((name.strip(), value.strip()))
        headers = {k.lower(): v for k, v in raw_headers}
        if "transfer-encoding" in headers:
            raise BadRequest(411, "a request body needs Content-Length")
        try:
            n = int(headers.get("content-length", "0"))
        except ValueError:
            raise BadRequest(400, "malformed Content-Length") from None
        if n < 0:
            raise BadRequest(400, "malformed Content-Length")
        if n > self.max_body:
            raise BadRequest(413, "request body too large")
        if headers.get("expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        body = await reader.readexactly(n) if n else b""
        return ServerRequest(method.upper(), target, raw_headers, body, remote, reader, writer,
                             accepted_at)


async def _read_line(reader: asyncio.StreamReader) -> str:
    """One CRLF-terminated line without its terminator; "" at EOF or on
    the blank line."""
    try:
        raw = await reader.readuntil(b"\n")
    except asyncio.IncompleteReadError as e:
        if e.partial:
            raise BadRequest(400, "truncated request") from None
        return ""
    except asyncio.LimitOverrunError:
        raise BadRequest(431, "request line or header too long") from None
    if len(raw) > MAX_LINE:
        raise BadRequest(431, "request line or header too long")
    return raw.rstrip(b"\r\n").decode("latin-1")


def _error_body(message: str) -> bytes:
    return json.dumps({"error": {"message": message}}).encode()
