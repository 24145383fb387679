"""The port's HTTP layer alone (gofr_tpu_torch.http.server and the App around
it, no model), held against the JAX App on the same handlers.

Tolerances: exact. For the same handlers and requests the port's App
answers the JAX App's status codes and JSON bodies byte for byte (the
JAX App runs under tests/test_http_server.py's ``AppHarness``, the port's
under the same harness). The wire rules of the stdlib server are checked
on raw sockets: ``Content-Length`` on whole responses, chunked transfer
and no ``Content-Length`` on streams, ``Connection: close``, ``Expect:
100-continue``, 400 / 411 / 413 on bad requests.
"""

import json
import socket
import threading
import time
from dataclasses import dataclass

import httpx
import pytest

from tests.test_http_server import AppHarness, _free_port

torch = pytest.importorskip("torch")


@dataclass
class Person:
    name: str
    age: int = 0


def _routes(app, errors_module):
    """The same handlers on either App: sync and async, a path parameter,
    a query parameter, a dataclass bind, a typed error, a dict result."""
    people = {}

    def greet(ctx):
        return f"Hello {ctx.param('name') or 'World'}!"

    async def create(ctx):
        p = ctx.bind(Person)
        people[p.name] = p
        return p

    def read(ctx):
        name = ctx.path_param("name")
        if name not in people:
            raise errors_module.EntityNotFound("name", name)
        return people[name]

    def header(ctx):
        return {"x": ctx.header("X-Thing"), "params": ctx.params("tag")}

    def boom(ctx):
        raise RuntimeError("internal detail")

    app.get("/greet", greet)
    app.post("/person", create)
    app.get("/person/{name}", read)
    app.get("/header", header)
    app.delete("/boom", boom)
    return app


def _port_app(extra=None):
    from gofr_tpu_torch.app import new_testing
    from gofr_tpu_torch.http import errors

    return _routes(new_testing({"HTTP_PORT": "0", "METRICS_PORT": "0", **(extra or {})}), errors)


def _jax_app():
    import gofr_tpu.app as appmod
    from gofr_tpu.config import DictConfig
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.http import errors

    config = {"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port())}
    return _routes(appmod.App(config=DictConfig(config), container=new_mock_container(config)),
                   errors)


REQUESTS = [
    ("GET", "/greet", {"params": {"name": "Ada"}}),
    ("GET", "/greet", {}),
    ("POST", "/person", {"json": {"name": "ada", "age": 36}}),
    ("GET", "/person/ada", {}),
    ("GET", "/person/nobody", {}),
    ("POST", "/person", {"content": b"{not json"}),
    ("POST", "/person", {"json": {"age": 3}}),
    ("GET", "/header", {"headers": {"X-Thing": "v"}, "params": {"tag": "a,b"}}),
    ("DELETE", "/boom", {}),
    ("GET", "/nowhere", {}),
    ("PUT", "/greet", {}),
    ("GET", "/.well-known/alive", {}),
    ("GET", "/.well-known/health", {}),
]


@pytest.mark.quick
def test_statuses_and_bodies_equal_the_jax_app():
    """Each request of ``REQUESTS`` in turn to both Apps: equal status and
    JSON body (health compared on its status and services, as the JAX
    container also reports its SLO plane)."""
    got, want = [], []
    for app, out in ((_port_app(), got), (_jax_app(), want)):
        with AppHarness(app) as h, httpx.Client(base_url=h.base, timeout=30) as c:
            for method, path, kw in REQUESTS:
                r = c.request(method, path, **kw)
                body = r.json()
                if path == "/.well-known/health":
                    body = (body["data"]["status"], body["data"]["services"].get("model:lm"))
                out.append((method, path, r.status_code, body))
    assert got == want


@pytest.mark.quick
def test_wire_rules_on_raw_sockets():
    """Content-Length on a whole response and Connection: close; Expect:
    100-continue answered before the body; a malformed request line is a
    400, a chunked request body a 411 and an oversize body a 413, each
    with the error envelope."""
    app = _port_app()
    with AppHarness(app) as h:
        def raw(data: bytes, wait_continue: bytes | None = None) -> bytes:
            with socket.create_connection(("127.0.0.1", app.http_port), timeout=10) as s:
                s.sendall(data)
                if wait_continue is not None:
                    assert s.recv(1024).startswith(b"HTTP/1.1 100 Continue")
                    s.sendall(wait_continue)
                out = b""
                while chunk := s.recv(65536):
                    out += chunk
                return out

        body = b'{"name": "bo", "age": 7}'
        out = raw(b"POST /person HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                  b"Expect: 100-continue\r\nContent-Length: %d\r\n\r\n" % len(body), body)
        head, _, payload = out.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 201 Created")
        assert b"Connection: close" in head and b"Content-Length: %d" % len(payload) in head
        assert json.loads(payload) == {"data": {"name": "bo", "age": 7}}

        chunked = b"6\r\n{\"name\r\n12\r\n\": \"cy\", \"age\": 9}\r\n0\r\n\r\n"
        out = raw(b"POST /person HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n" + chunked)
        assert out.startswith(b"HTTP/1.1 411") and b'"error"' in out

        out = raw(b"NOT A REQUEST\r\n\r\n")
        assert out.startswith(b"HTTP/1.1 400") and b'"error"' in out
        out = raw(b"POST /person HTTP/1.1\r\nContent-Length: %d\r\n\r\n" % (1 << 40))
        assert out.startswith(b"HTTP/1.1 413") and b'"error"' in out


class _Stream:
    """A blocking iterator of items with ``cancel``, as the engine's
    ``StreamIterator`` is: each item after the first waits for ``go``."""

    def __init__(self, n: int):
        self.n, self.i = n, 0
        self.go = threading.Event()
        self.cancelled = threading.Event()

    def __iter__(self):
        return self

    def __next__(self):
        if self.i and not self.go.wait(30):
            raise TimeoutError("client never read the first event")
        if self.cancelled.is_set() or self.i >= self.n:
            raise StopIteration
        self.i += 1
        time.sleep(0.01)
        return f"piece {self.i}"

    def cancel(self, reason="client_disconnect"):
        self.cancelled.set()


@pytest.mark.quick
def test_sse_is_chunked_flushed_and_cancelled_when_the_client_goes():
    """A StreamingResponse goes out as text/event-stream in chunked
    transfer with no Content-Length, its first event on the wire before the
    iterator yields the second (it waits for the client to read the first);
    the frames are the JAX package's bytes. A client that closes mid-stream
    makes the server cancel the iterator."""
    from gofr_tpu.http.streaming import StreamingResponse as JaxSSE
    from gofr_tpu_torch.http.streaming import StreamingResponse

    streams = []

    def stream(ctx):
        streams.append(_Stream(int(ctx.param("n"))))
        return StreamingResponse(streams[-1], event="token")

    app = _port_app()
    app.get("/stream", stream)
    with AppHarness(app) as h, httpx.Client(base_url=h.base, timeout=30) as c:
        lines = []
        with c.stream("GET", "/stream", params={"n": 3}) as r:
            assert r.status_code == 200
            assert r.headers["content-type"] == "text/event-stream"
            assert r.headers["transfer-encoding"] == "chunked"
            assert "content-length" not in r.headers
            for line in r.iter_lines():
                lines.append(line)
                streams[0].go.set()
        want = JaxSSE(iter(()), event="token")
        frames = b"".join(want.encode_sse(f"piece {i}") for i in (1, 2, 3)) + JaxSSE.sse_done()
        assert "\n".join(lines) + "\n" == frames.decode()

        with c.stream("GET", "/stream", params={"n": 10_000}) as r:
            for line in r.iter_lines():
                if line.startswith("data: "):
                    break
        streams[1].go.set()
        assert streams[1].cancelled.wait(30), "the server did not cancel a dropped stream"
        assert streams[1].i < 10_000


@pytest.mark.quick
def test_request_timeout_and_an_expired_deadline():
    """``REQUEST_TIMEOUT`` bounds a handler (408, and the engine work it
    submitted is cancelled through ``ctx.cancel_inflight``); a client
    deadline already past is a 504 before the handler runs; a deadline
    tighter than the timeout is a 504 too."""
    from gofr_tpu_torch import deadline

    class FakeRequest:
        cancelled = False

        def cancel(self, reason):
            self.cancelled, self.reason = True, reason

    submitted, ran = [], []

    def slow(ctx):
        ran.append(1)
        submitted.append(FakeRequest())
        ctx._engine_requests.append(submitted[-1])
        time.sleep(1.0)
        return "late"

    app = _port_app({"REQUEST_TIMEOUT": "0.3"})
    app.get("/slow", slow)
    with AppHarness(app) as h, httpx.Client(base_url=h.base, timeout=30) as c:
        r = c.get("/slow")
        assert (r.status_code, r.json()) == (408, {"error": {"message": "request timed out"}})
        assert submitted[0].cancelled and submitted[0].reason == "timeout"
        past = str(int((time.time() - 5) * 1000))
        r = c.get("/slow", headers={deadline.DEADLINE_HEADER: past})
        assert (r.status_code, r.json()) == (504, {"error": {"message": "request deadline already expired"}})
        assert len(ran) == 1
        soon = str(int((time.time() + 0.1) * 1000))
        r = c.get("/slow", headers={deadline.DEADLINE_HEADER: soon})
        assert r.status_code == 504 and submitted[1].reason == "deadline"


@pytest.mark.quick
def test_metrics_port_and_two_apps_in_one_process():
    """Two Apps on free ports at once; each one's metrics port shows
    ``app_http_response`` by route template, method and status."""
    a, b = _port_app(), _port_app()
    with AppHarness(a) as ha, AppHarness(b) as hb:
        assert len({a.http_port, a.metrics_port, b.http_port, b.metrics_port}) == 4
        for h in (ha, hb):
            with httpx.Client(base_url=h.base, timeout=30) as c:
                assert c.get("/greet").status_code == 200
                assert c.get("/person/x").status_code == 404
        text = httpx.get(f"http://127.0.0.1:{a.metrics_port}/metrics", timeout=30).text
        assert 'app_http_response_count{method="GET",path="/greet",status="200"} 1' in text
        assert 'app_http_response_count{method="GET",path="/person/{name}",status="404"} 1' in text
        assert "app_info{" in text
        r = httpx.get(f"http://127.0.0.1:{a.metrics_port}/nothing", timeout=30)
        assert r.status_code == 404


def test_router_templates_and_the_fallback():
    """``{name}`` matches one percent-decoded segment; the first route
    registered wins; an unmatched method or path goes to the fallback
    under its template."""
    from gofr_tpu_torch.http.server import Router, ServerRequest

    def req(method, target):
        return ServerRequest(method, target, [], b"", "", None, None, 0.0)

    fallback = object()
    r = Router(fallback)
    a, b, c = object(), object(), object()
    r.add("GET", "/a/{x}", a)
    r.add("GET", "/a/{x}", b)
    r.add("POST", "/f/{x}/{y}.txt", c)
    q = req("GET", "/a/h%20i?z=1")
    assert r.resolve(q) is a and q.path_params == {"x": "h i"} and q.query_string == "z=1"
    q = req("POST", "/f/x/y.txt")
    assert r.resolve(q) is c and q.path_params == {"x": "x", "y": "y"}
    assert q.route_template == "/f/{x}/{y}.txt"
    for method, target in (("POST", "/a/1"), ("GET", "/a/1/2"), ("GET", "/b")):
        q = req(method, target)
        assert r.resolve(q) is fallback and q.route_template == "/{tail}"


@pytest.mark.quick
def test_request_context_carries_the_server_accept_and_read_times():
    """The handler's request context holds the monotonic times the server
    accepted the connection and had read the request, both before the
    handler ran."""
    seen = []

    def stamps(ctx):
        seen.append((ctx.request.context()["accepted_at"], ctx.request.context()["read_at"],
                     time.monotonic()))
        return "ok"

    app = _port_app()
    app.get("/stamps", stamps)
    t0 = time.monotonic()
    with AppHarness(app) as h, httpx.Client(base_url=h.base, timeout=30) as c:
        assert c.get("/stamps").status_code == 200
    accepted, read, handled = seen[0]
    assert t0 <= accepted <= read <= handled
