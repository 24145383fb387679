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
  it (no keep-alive), with one exception: a handler may upgrade a ``GET``
  to a websocket (``ServerRequest.upgrade_websocket``, RFC 6455 with
  ``hashlib``, ``base64`` and ``struct``), and then owns the connection
  until the session ends (``WebSocket``);
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
import base64
import dataclasses
import hashlib
import json
import re
import struct
import time
from http import HTTPStatus
from typing import Any, Awaitable, Callable
from urllib.parse import unquote

Handler = Callable[["ServerRequest"], Awaitable["ServerResponse"]]
Middleware = Callable[["ServerRequest", Handler], Awaitable["ServerResponse"]]

MAX_LINE = 16 * 1024
MAX_HEADERS = 128
# RFC 6455: the GUID the accept key hashes in, and the largest message a
# session takes (aiohttp's default, which the JAX App serves with)
WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
WS_MAX_MESSAGE = 4 * 1024 * 1024
WS_TEXT, WS_BINARY, WS_CONTINUATION = 0x1, 0x2, 0x0
WS_CLOSE, WS_PING, WS_PONG = 0x8, 0x9, 0xA
# close codes: normal, going away, protocol error, bad UTF-8, too big
WS_NORMAL, WS_GOING_AWAY, WS_PROTOCOL_ERROR, WS_INVALID_DATA, WS_TOO_BIG = (
    1000, 1001, 1002, 1007, 1009)


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


def ws_accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``."""
    return base64.b64encode(hashlib.sha1((key + WS_GUID).encode("latin-1")).digest()).decode()


def ws_frame(opcode: int, payload: bytes, *, fin: bool = True, mask: bytes | None = None) -> bytes:
    """One frame: FIN, the opcode, the 7-, 16- or 64-bit length, and the
    payload, masked with ``mask`` when one is given (a client's frames)."""
    n = len(payload)
    head = bytes([(0x80 if fin else 0) | opcode])
    bit = 0x80 if mask is not None else 0
    if n < 126:
        head += bytes([bit | n])
    elif n < 1 << 16:
        head += bytes([bit | 126]) + struct.pack("!H", n)
    else:
        head += bytes([bit | 127]) + struct.pack("!Q", n)
    if mask is not None:
        head += mask
        payload = ws_unmask(payload, mask)
    return head + payload


def ws_unmask(payload: bytes, mask: bytes) -> bytes:
    """XOR ``payload`` with the 4-byte ``mask`` (its own inverse)."""
    n = len(payload)
    if not n:
        return payload
    key = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(payload, "big") ^ int.from_bytes(key, "big")).to_bytes(n, "big")


@dataclasses.dataclass
class WSMessage:
    """A whole received message: ``text`` (str data) or ``binary``."""

    type: str
    data: str | bytes


class WebSocket:
    """The server side of one RFC 6455 session over the connection's
    streams. ``receive`` (or ``async for``) yields whole messages: fragments
    are reassembled, pings answered with pongs, and the close handshake
    echoes the peer's code; it yields None once the session is over. A
    protocol fault closes the session with its code: an unmasked client
    frame, a reserved bit, an unknown opcode or a stray continuation 1002,
    text that is not UTF-8 1007, a message over ``max_message`` 1009.
    ``send_str`` / ``send_bytes`` write one unmasked frame each and raise
    ``ConnectionResetError`` once the client has gone."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 max_message: int = WS_MAX_MESSAGE):
        self._reader, self._writer = reader, writer
        self.max_message = max_message
        self.close_code: int | None = None
        self._close_sent = False

    @property
    def closed(self) -> bool:
        return self.close_code is not None or self._close_sent

    def _check(self) -> None:
        if self._close_sent or self._writer.is_closing() or self._reader.at_eof():
            raise ConnectionResetError("websocket closed")

    async def _write(self, opcode: int, payload: bytes) -> None:
        self._writer.write(ws_frame(opcode, payload))
        await self._writer.drain()

    async def send_str(self, data: str) -> None:
        self._check()
        await self._write(WS_TEXT, data.encode())

    async def send_bytes(self, data: bytes) -> None:
        self._check()
        await self._write(WS_BINARY, bytes(data))

    async def close(self, code: int = WS_NORMAL, reason: str = "") -> None:
        """Send a close frame (once); the peer's answer ends ``receive``."""
        if self._close_sent:
            return
        self._close_sent = True
        try:
            await self._write(WS_CLOSE, struct.pack("!H", code) + reason.encode()[:120])
        except (ConnectionError, RuntimeError):
            pass

    async def _fail(self, code: int, reason: str) -> None:
        self.close_code = code
        await self.close(code, reason)

    def __aiter__(self):
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg is None:
            raise StopAsyncIteration
        return msg

    async def receive(self) -> WSMessage | None:
        parts: list[bytes] = []
        kind = None
        size = 0
        while self.close_code is None:
            try:
                head = await self._reader.readexactly(2)
                fin, opcode = head[0] & 0x80, head[0] & 0x0F
                masked, n = head[1] & 0x80, head[1] & 0x7F
                if head[0] & 0x70:
                    await self._fail(WS_PROTOCOL_ERROR, "reserved bits set")
                    break
                if not masked:
                    await self._fail(WS_PROTOCOL_ERROR, "client frames must be masked")
                    break
                if n == 126:
                    n = struct.unpack("!H", await self._reader.readexactly(2))[0]
                elif n == 127:
                    n = struct.unpack("!Q", await self._reader.readexactly(8))[0]
                if opcode >= WS_CLOSE and (not fin or n > 125):
                    await self._fail(WS_PROTOCOL_ERROR, "bad control frame")
                    break
                if opcode < WS_CLOSE and size + n > self.max_message:
                    await self._fail(WS_TOO_BIG, "message too big")
                    break
                mask = await self._reader.readexactly(4)
                payload = ws_unmask(await self._reader.readexactly(n), mask)
            except (asyncio.IncompleteReadError, ConnectionError):
                self.close_code = 1006  # gone without a close frame
                break
            if opcode == WS_PING:
                try:
                    await self._write(WS_PONG, payload)
                except ConnectionError:
                    self.close_code = 1006
                    break
                continue
            if opcode == WS_PONG:
                continue
            if opcode == WS_CLOSE:
                code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else WS_NORMAL
                self.close_code = code
                await self.close(code)  # the echo, unless this side began the close
                break
            if opcode == WS_CONTINUATION:
                if kind is None:
                    await self._fail(WS_PROTOCOL_ERROR, "continuation without a message")
                    break
            elif opcode in (WS_TEXT, WS_BINARY):
                if kind is not None:
                    await self._fail(WS_PROTOCOL_ERROR, "new message inside a fragmented one")
                    break
                kind = opcode
            else:
                await self._fail(WS_PROTOCOL_ERROR, f"unknown opcode {opcode}")
                break
            parts.append(payload)
            size += n
            if not fin:
                continue
            data = b"".join(parts)
            if kind == WS_BINARY:
                return WSMessage("binary", data)
            try:
                return WSMessage("text", data.decode("utf-8"))
            except UnicodeDecodeError:
                await self._fail(WS_INVALID_DATA, "text is not UTF-8")
                break
        return None


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
        self.websocket: WebSocket | None = None
        # the server's live sessions, so closing it can close them
        self.websockets: set[WebSocket] | None = None
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

    def is_websocket_upgrade(self) -> bool:
        h = self.headers
        return (self.method == "GET" and h.get("upgrade", "").lower() == "websocket"
                and "upgrade" in h.get("connection", "").lower()
                and h.get("sec-websocket-version") == "13" and bool(h.get("sec-websocket-key")))

    async def upgrade_websocket(self) -> WebSocket | None:
        """Answer an RFC 6455 upgrade with ``101 Switching Protocols`` and
        return the session, which then owns the connection; None (nothing
        written) when the request is not a version-13 upgrade."""
        if not self.is_websocket_upgrade():
            return None
        accept = ws_accept_key(self.headers["sec-websocket-key"])
        self._writer.write(("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                            f"Connection: Upgrade\r\nSec-WebSocket-Accept: {accept}\r\n\r\n")
                           .encode("latin-1"))
        await self._writer.drain()
        self.websocket = WebSocket(self._reader, self._writer)
        if self.websockets is not None:
            self.websockets.add(self.websocket)
        return self.websocket


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
    matches one path segment, ``{name:regex}`` what the regex matches (as
    in aiohttp: ``{tail:.*}`` takes the rest of the path). The first route
    registered for a (method, path) wins; a request no route matches goes
    to ``fallback`` with ``fallback_template``."""

    _PARAM = re.compile(r"\{(\w+)(?::([^{}]+))?\}")

    def __init__(self, fallback: Handler, fallback_template: str = "/{tail}"):
        self._routes: list[tuple[str, re.Pattern, str, Handler]] = []
        self.fallback, self.fallback_template = fallback, fallback_template

    def add(self, method: str, template: str, handler: Handler) -> None:
        pattern, pos = "", 0
        for m in self._PARAM.finditer(template):
            pattern += re.escape(template[pos:m.start()])
            pattern += f"(?P<{m.group(1)}>{m.group(2) or '[^/]+'})"
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
        self._websockets: set[WebSocket] = set()

    async def start(self, host: str = "0.0.0.0", port: int = 0) -> None:
        self._server = await asyncio.start_server(self._client, host, port, limit=MAX_LINE * 4)
        self.port = self._server.sockets[0].getsockname()[1]

    async def close(self, grace: float = 5.0) -> None:
        if self._server is None:
            return
        self._server.close()
        for ws in list(self._websockets):
            await ws.close(WS_GOING_AWAY)
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
        request.websockets = self._websockets
        handler = chain(self.middlewares, self.router.resolve(request))
        try:
            resp = await handler(request)
        except ConnectionError:
            raise  # the client went away: nobody to answer
        except Exception as e:  # noqa: BLE001 - a handler's fault is the client's 500
            if self.on_error is not None:
                self.on_error(e)
            if request.stream is not None or request.websocket is not None:
                return  # the status line is on the wire already
            resp = ServerResponse(500, _error_body("some unexpected error has occurred"))
        finally:
            if request.websocket is not None:
                self._websockets.discard(request.websocket)
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
