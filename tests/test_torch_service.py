"""The port's inter-service HTTP client (``gofr_tpu_torch.service``) and
retry budget (``service.budget``) held to tests/test_service_client.py's
cases against the same local backends, to the retry-budget and Retry
cases of tests/test_resilience.py on the same stub transport and fake
clock, to the port's own HTTP server (bodies, query strings, a streamed
SSE reply, the deadline header), and against the JAX package.

Tolerances: exact. ``Retry``'s sleeps are equal under the same seeded
``rng`` and script; ``CircuitBreaker``'s state sequence is equal under the
same failure sequence (its probe interval injected at 0.05 s, so no test
waits longer than that for a state change).
"""

import asyncio
import json
import random
import threading
import time

import pytest

from tests.test_http_server import AppHarness, _free_port
from tests.test_resilience import _Clock, _Resp, _StubInner
from tests.test_service_client import Backend, StreamBackend, backend, stream_backend  # noqa: F401

torch = pytest.importorskip("torch")


def svc():
    import gofr_tpu_torch.service as mod

    return mod


# -- tests/test_service_client.py on the port ------------------------------------------------


@pytest.mark.quick
def test_base_client_get_logs_and_metrics(backend):
    from gofr_tpu_torch.logging import MockLogger
    from gofr_tpu_torch.metrics import Registry

    log, reg = MockLogger(), Registry()
    reg.new_histogram("app_http_service_response")
    client = svc().new_http_service(backend, log, reg)
    resp = client.get("/data")
    assert resp.ok and resp.json() == {"data": "ok"}
    assert reg.get("app_http_service_response").count(service=backend, method="GET",
                                                      status="200") == 1
    assert any(r.get("message") == "http service call" for r in log.records)


def test_retry_recovers_from_5xx(backend):
    Backend.fail_times = 2
    client = svc().new_http_service(backend, None, None, svc().Retry(max_retries=3, backoff=0.01))
    assert client.get("/flaky").status_code == 200


def test_retry_exhausted_raises(backend):
    Backend.fail_times = 10
    client = svc().new_http_service(backend, None, None, svc().Retry(max_retries=1, backoff=0.01))
    with pytest.raises(svc().ServiceError):
        client.get("/flaky")


def test_circuit_breaker_opens_and_recovers(backend):
    Backend.fail_times = 3
    client = svc().new_http_service(backend, None, None,
                                    svc().CircuitBreaker(threshold=3, interval=0.1))
    for _ in range(3):
        assert client.get("/flaky").status_code == 500
    n = len(Backend.requests)
    with pytest.raises(svc().ServiceError, match="circuit breaker is open"):
        client.get("/flaky")
    assert len([r for r in Backend.requests[n:] if not r[0].startswith("/.well-known")]) == 0
    deadline = time.time() + 3
    while client.is_open and time.time() < deadline:
        time.sleep(0.05)
    assert not client.is_open
    assert client.get("/data").status_code == 200
    client.close()


def test_auth_and_header_options_compose(backend):
    s = svc()
    client = s.new_http_service(backend, None, None, s.BasicAuthOption("u", "p"),
                                s.APIKeyOption("k123"), s.DefaultHeaders(X_Env="prod"))
    client.get("/who")
    _, headers = Backend.requests[-1]
    assert headers["Authorization"].startswith("Basic ")
    assert headers["X-API-KEY"] == "k123"
    assert headers["X-Env"] == "prod"


def test_traceparent_propagation(backend):
    from gofr_tpu_torch.tracing import MemoryExporter, Tracer

    tracer = Tracer(MemoryExporter())
    client = svc().new_http_service(backend, None, None)
    with tracer.span("parent") as span:
        client.get("/traced")
    _, headers = Backend.requests[-1]
    assert headers["traceparent"].split("-")[1] == span.trace_id


def test_health_check(backend):
    client = svc().new_http_service(backend, None, None)
    assert client.health_check()["status"] == "UP"
    dead = svc().new_http_service(f"http://127.0.0.1:{_free_port()}", None, None)
    assert dead.health_check()["status"] == "DOWN"


def test_streamed_response_chunks_arrive_incrementally(stream_backend):
    client = svc().new_http_service(stream_backend, None, None)
    resp = client.request("GET", "/stream", stream=True)
    assert resp.status_code == 200 and resp.ok
    assert resp.headers["content-type"] == "text/event-stream"
    it = resp.iter_content()
    got = b""
    while b"one" not in got:
        got += next(it)
    assert b"two" not in got
    StreamBackend.release.set()
    for chunk in it:
        got += chunk
    assert b"two" in got
    client.close()


def test_streamed_response_close_aborts_upstream(stream_backend):
    client = svc().new_http_service(stream_backend, None, None)
    resp = client.request("GET", "/stream", stream=True)
    assert b"one" in next(resp.iter_content())
    resp.close()
    resp.close()
    StreamBackend.release.set()
    deadline = time.time() + 5
    while not StreamBackend.write_error and time.time() < deadline:
        time.sleep(0.02)
    assert StreamBackend.write_error
    client.close()


# -- the retry budget and the Retry option (tests/test_resilience.py:107-242) ----------------


def budget_cls():
    from gofr_tpu_torch.service.budget import RetryBudget

    return RetryBudget


@pytest.mark.quick
class TestRetryBudget:
    def test_min_retries_floor_on_idle_client(self):
        b = budget_cls()(fraction=0.2, min_retries=3, window_s=10.0, clock=_Clock())
        assert b.allowed() == 3
        assert [b.try_spend() for _ in range(4)] == [True, True, True, False]

    def test_fraction_caps_the_aggregate(self):
        b = budget_cls()(fraction=0.2, min_retries=3, window_s=10.0, clock=_Clock())
        for _ in range(100):
            b.note_request()
        assert b.allowed() == 20
        assert sum(1 for _ in range(100) if b.try_spend()) == 20

    def test_window_slide_refills(self):
        clk = _Clock()
        b = budget_cls()(fraction=0.5, min_retries=0, window_s=10.0, clock=clk)
        b.note_request()
        b.note_request()
        assert b.try_spend() and not b.try_spend()
        clk.t = 11.0
        b.note_request()
        b.note_request()
        assert b.try_spend()

    def test_metrics_and_snapshot(self):
        from gofr_tpu_torch.container import new_mock_container

        c = new_mock_container()
        b = budget_cls()(fraction=0.0, min_retries=1, window_s=10.0, metrics=c.metrics,
                         clock=_Clock())
        b.note_request()
        assert b.try_spend() and not b.try_spend()
        assert c.metrics.get("app_retry_budget_spent_total").value() == 1
        assert c.metrics.get("app_retry_budget_exhausted_total").value() == 1
        snap = b.snapshot()
        assert snap["window_requests"] == 1 and snap["window_retries"] == 1


@pytest.mark.quick
class TestRetryMiddleware:
    def _sleeps(self, monkeypatch):
        rec: list[float] = []
        monkeypatch.setattr(time, "sleep", rec.append)
        return rec

    def test_full_jitter_bounded_by_exponential_envelope(self, monkeypatch):
        sleeps = self._sleeps(monkeypatch)
        inner = _StubInner([svc().ServiceError("x"), svc().ServiceError("x"), _Resp(200)])
        client = svc().Retry(max_retries=3, backoff=0.05, rng=random.Random(7)).add_option(inner)
        assert client.request("GET", "/x").status_code == 200
        assert inner.calls == 3
        for i, s in enumerate(sleeps):
            assert 0.0 <= s <= 0.05 * (2 ** i)

    def test_retry_after_overrides_backoff(self, monkeypatch):
        sleeps = self._sleeps(monkeypatch)
        inner = _StubInner([_Resp(503, {"Retry-After": "0.07"}), _Resp(200)])
        client = svc().Retry(max_retries=2, backoff=5.0).add_option(inner)
        assert client.request("GET", "/x").status_code == 200
        assert sleeps == [0.07]

    def test_429_with_hint_retries_bare_429_returns(self, monkeypatch):
        self._sleeps(monkeypatch)
        hinted = _StubInner([_Resp(429, {"retry-after": "0.01"}), _Resp(200)])
        assert svc().Retry(max_retries=2, backoff=0.01).add_option(hinted).request(
            "GET", "/x").status_code == 200
        assert hinted.calls == 2
        bare = _StubInner([_Resp(429)])
        assert svc().Retry(max_retries=2, backoff=0.01).add_option(bare).request(
            "GET", "/x").status_code == 429
        assert bare.calls == 1

    def test_retry_after_capped_at_remaining_deadline(self, monkeypatch):
        from gofr_tpu_torch import deadline

        sleeps = self._sleeps(monkeypatch)
        hdrs = {deadline.DEADLINE_HEADER: deadline.header_value(time.monotonic() + 0.05)}
        inner = _StubInner([_Resp(503, {"Retry-After": "9"}), _Resp(200)])
        svc().Retry(max_retries=2, backoff=0.01).add_option(inner).request("GET", "/x",
                                                                           headers=hdrs)
        assert len(sleeps) == 1 and sleeps[0] <= 0.06

    def test_expired_deadline_stops_retrying(self, monkeypatch):
        from gofr_tpu_torch import deadline

        self._sleeps(monkeypatch)
        hdrs = {deadline.DEADLINE_HEADER: deadline.header_value(time.monotonic() - 1.0)}
        inner = _StubInner([svc().ServiceError("x"), _Resp(200)])
        with pytest.raises(svc().ServiceError):
            svc().Retry(max_retries=3, backoff=0.01).add_option(inner).request("GET", "/x",
                                                                               headers=hdrs)
        assert inner.calls == 1

    def test_budget_gates_retries_and_counts_originals(self, monkeypatch):
        self._sleeps(monkeypatch)
        budget = budget_cls()(fraction=0.0, min_retries=1, window_s=10.0, clock=_Clock())
        inner = _StubInner([svc().ServiceError("x")] * 4)
        with pytest.raises(svc().ServiceError):
            svc().Retry(max_retries=3, backoff=0.01, budget=budget).add_option(inner).request(
                "GET", "/x")
        assert inner.calls == 2
        assert budget.snapshot()["window_requests"] == 1


# -- parity with the JAX package -------------------------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_retry_sleeps_equal_the_jax_package(monkeypatch, seed):
    """The same script (two transport errors, a 503 with a Retry-After
    hint, a bare 503, then 200) through both packages' Retry under
    ``random.Random(seed)``: equal sleeps, equal calls, equal answer."""
    import gofr_tpu.service as jsvc

    sleeps: list[float] = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    out = {}
    for name, mod in (("jax", jsvc), ("port", svc())):
        del sleeps[:]
        inner = _StubInner([mod.ServiceError("a"), mod.ServiceError("b"),
                            _Resp(503, {"Retry-After": "0.25"}), _Resp(503), _Resp(200)])
        client = mod.Retry(max_retries=5, backoff=0.05, rng=random.Random(seed)).add_option(inner)
        status = client.request("GET", "/x").status_code
        out[name] = (status, inner.calls, list(sleeps))
    assert out["port"] == out["jax"]
    assert out["port"][0] == 200 and out["port"][1] == 5 and out["port"][2][2] == 0.25


class _BreakerInner:
    """A scripted inner client for the breaker: answers statuses (or
    raises the package's ServiceError for "err"), and reads DOWN to the
    probe until ``up`` is set."""

    def __init__(self, mod, script):
        self.mod, self.script, self.up, self.probes = mod, list(script), False, 0

    def request(self, method, path, **kw):
        item = self.script.pop(0)
        if item == "err":
            raise self.mod.ServiceError("refused")
        return _Resp(item)

    def health_check(self, **kw):
        self.probes += 1
        return {"status": "UP" if self.up else "DOWN", "details": {}}

    def close(self):
        pass

    @property
    def base_url(self):
        return "stub"


def test_breaker_states_equal_the_jax_package():
    """The same failure sequence (500, 500, 200, then a refused connection
    and two 500s) through both packages' breaker at threshold 3: the same
    answers and open/closed states call by call, then fast failure while
    open, the probe closing it once the upstream reads UP, and a call
    through again."""
    import gofr_tpu.service as jsvc

    script = [500, 500, 200, "err", 500, 500, 200]
    out = {}
    for name, mod in (("jax", jsvc), ("port", svc())):
        inner = _BreakerInner(mod, script)
        cb = mod.CircuitBreaker(threshold=3, interval=0.05).add_option(inner)
        seq = []
        for _ in range(6):
            try:
                seq.append((cb.request("GET", "/x").status_code, cb.is_open))
            except mod.ServiceError as e:
                seq.append((str(e), cb.is_open))
        inner.up = True
        deadline = time.monotonic() + 5
        while cb.is_open and time.monotonic() < deadline:
            time.sleep(0.01)
        seq.append((cb.request("GET", "/x").status_code, cb.is_open))
        seq.append(cb.health_check()["details"]["circuit_open"])
        out[name] = seq
        if name == "port":
            cb.close()
    assert out["port"] == out["jax"]
    assert out["port"][:6] == [(500, False), (500, False), (200, False), ("refused", False),
                               (500, False), (500, True)]
    assert out["port"][6:] == [(200, False), False]


# -- against the port's own server -----------------------------------------------------------


def test_client_against_the_port_s_server():
    """The client on the port's stdlib server: a POST body (sent with
    Content-Length) and a query string reach the handler, a streamed SSE
    reply arrives frame by frame through ``iter_content``, the deadline
    header the caller stamps is the handler's ``deadline_remaining``, the
    health check reads the App's alive route, and a closed port is a
    ServiceError."""
    from gofr_tpu_torch import deadline
    from gofr_tpu_torch.app import new_testing
    from gofr_tpu_torch.http.streaming import StreamingResponse

    app = new_testing({"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port())})
    seen = {}

    def echo(ctx):
        seen["remaining"] = ctx.deadline_remaining()
        return {"body": ctx.bind(dict), "q": ctx.param("q")}

    def stream(ctx):
        return StreamingResponse(iter(range(3)), event="n")

    async def slow(ctx):
        await asyncio.sleep(0.01)
        return "ok"

    app.post("/echo", echo)
    app.get("/stream", stream)
    app.get("/slow", slow)
    s = svc()
    with AppHarness(app) as h:
        client = s.new_http_service(h.base, None, None)
        hdrs = {"Content-Type": "application/json",
                deadline.DEADLINE_HEADER: deadline.header_value(time.monotonic() + 30)}
        resp = client.post("/echo", body=json.dumps({"a": [1, 2]}).encode(), params={"q": "z"},
                           headers=hdrs)
        assert resp.status_code == 201 and resp.json() == {"data": {"body": {"a": [1, 2]},
                                                                    "q": "z"}}
        assert 25 < seen["remaining"] <= 30
        assert "content-type" in resp.headers
        r = client.request("GET", "/stream", stream=True)
        assert r.status_code == 200 and r.headers["content-type"] == "text/event-stream"
        body = b"".join(r.iter_content())
        assert body == b"".join(b"event: n\ndata: %d\n\n" % i for i in range(3)) + (
            b"event: done\ndata: {}\n\n")
        assert client.get("/slow").json() == {"data": "ok"}
        assert client.health_check()["status"] == "UP"
        client.close()
    dead = s.new_http_service(h.base, None, None)
    with pytest.raises(s.ServiceError):
        dead.get("/echo")


def test_closing_the_breaker_ends_its_probe():
    """A breaker opened against an upstream that never comes back: its
    probe thread ends when the client closes (the App closes its service
    clients at shutdown)."""
    s = svc()
    client = s.new_http_service(f"http://127.0.0.1:{_free_port()}", None, None,
                                s.CircuitBreaker(threshold=2, interval=0.05))
    for _ in range(2):
        with pytest.raises(s.ServiceError):
            client.get("/x")
    assert client.is_open and client._probe.is_alive()
    probe = client._probe
    client.close()
    assert not probe.is_alive()
    assert not [t for t in threading.enumerate() if t is probe]


def test_on_cleanup_runs_before_the_container_closes_its_services():
    """``App.on_cleanup`` functions run at shutdown while the registered
    service clients are still open; the container closes them after."""
    from gofr_tpu_torch.app import new_testing

    app = new_testing({"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port())})
    app.get("/ok", lambda ctx: "ok")
    client = app.register_service("peer", f"http://127.0.0.1:{_free_port()}")
    assert app.container.http_service("peer") is client
    seen = []
    app.on_cleanup(lambda: seen.append(client._closed))
    app.on_cleanup(lambda: 1 / 0)  # a failing hook does not stop the others
    app.on_cleanup(lambda: seen.append("after"))
    with AppHarness(app):
        pass
    assert seen == [False, "after"] and client._closed
    with pytest.raises(KeyError, match="no HTTP service registered as 'nope'"):
        app.container.http_service("nope")
