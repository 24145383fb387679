"""Inter-service HTTP client: options-as-decorators with circuit breaker/retry/auth.

Parity with gofr `pkg/gofr/service/`: ``new_http_service(addr, logger, metrics,
*options)`` folds each option over the base client (`new.go:68-87`) — every
option is itself a full client wrapping the next, so auth, retry and circuit
breaking compose freely. Every request gets a client span, traceparent
injection, a structured log and an ``app_http_service_response`` histogram
(`new.go:140-197`). Health checks GET ``/.well-known/alive`` (`health.go:20-35`).

The port's own copy of gofr_tpu/service/__init__.py, on the standard
library's ``http.client`` where the JAX client runs httpx (the port depends
on no HTTP library outside the standard library): the same classes,
options and errors, response headers keyed in lower case as httpx keys
them.
"""

from __future__ import annotations

import base64
import http.client
import json
import random
import threading
import time
import urllib.parse
import urllib.request
from typing import Any

from gofr_tpu_torch.tracing import current_span

# what a failed exchange raises on the standard library's client: refused
# or reset connections and timeouts (OSError), malformed replies
# (HTTPException) — httpx.HTTPError's cases in the JAX client
_TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


def _lower(headers: list[tuple[str, str]]) -> dict[str, str]:
    """Response headers keyed in lower case, as httpx hands them out."""
    return {k.lower(): v for k, v in headers}


class ServiceResponse:
    def __init__(self, status_code: int, body: bytes, headers: dict[str, str]):
        self.status_code = status_code
        self.body = body
        self.headers = headers

    def json(self) -> Any:
        return json.loads(self.body)

    @property
    def ok(self) -> bool:
        return 200 <= self.status_code < 300

    def close(self) -> None:  # symmetry with StreamedServiceResponse
        pass


class StreamedServiceResponse:
    """Headers-first response for ``request(..., stream=True)``: status and
    headers are available immediately, the body arrives incrementally
    through ``iter_content`` — the shape SSE/chunked proxying needs. The
    caller MUST exhaust ``iter_content`` or call ``close()``; the
    connection is held until then, and ``close()`` mid-stream aborts the
    upstream transfer (client-cancel propagation)."""

    def __init__(self, conn: http.client.HTTPConnection, resp: http.client.HTTPResponse):
        self._conn = conn
        self._resp = resp
        self.status_code = resp.status
        self.headers = _lower(resp.getheaders())
        self._closed = False

    @property
    def ok(self) -> bool:
        return 200 <= self.status_code < 300

    def iter_content(self, chunk_size: int | None = None):
        """Body chunks AS THEY ARRIVE (``read1``: at most one read of the
        socket a chunk, never waiting for a full ``chunk_size``, which
        would hold an SSE frame back; the request pinned identity
        encoding). Closes on exhaustion and on generator teardown, so a
        ``break`` releases the connection too."""
        try:
            while True:
                data = self._resp.read1(chunk_size or 65536)
                if not data:
                    return
                yield data
        finally:
            self.close()

    def read(self) -> bytes:
        """Materialize the remaining body and close."""
        try:
            return self._resp.read()
        finally:
            self.close()

    def json(self) -> Any:
        return json.loads(self.read())

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._resp.close()
            self._conn.close()


class HTTPService:
    """Base client (terminal element of the decorator chain), on the
    standard library's ``http.client``: one connection a request (the
    port's server closes every connection after its response), bodies
    sent with ``Content-Length``."""

    def __init__(self, base_url: str, logger=None, metrics=None, tracer=None, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        url = urllib.parse.urlsplit(self.base_url)
        if url.scheme not in ("http", "https") or not url.hostname:
            raise ValueError(f"service address {base_url!r}: want http(s)://host[:port][/path]")
        self._https = url.scheme == "https"
        self._host = url.hostname
        self._port = url.port
        self._prefix = url.path
        self._logger = logger
        self._metrics = metrics
        self._tracer = tracer
        self._timeout = timeout
        self._closed = False

    def _open(self, method: str, path: str, params: dict | None, body: bytes | None,
              headers: dict[str, str], timeout: float):
        """Send one request; (connection, response) once the headers are in."""
        if self._closed:
            raise RuntimeError("cannot send a request, as the client has been closed")
        target = f"{self._prefix}/{path.lstrip('/')}"
        if params:
            target += ("&" if "?" in target else "?") + urllib.parse.urlencode(params, doseq=True)
        cls = http.client.HTTPSConnection if self._https else http.client.HTTPConnection
        conn = cls(self._host, self._port, timeout=timeout)
        try:
            conn.request(method, target, body=body, headers=headers)
            return conn, conn.getresponse()
        except BaseException:
            conn.close()
            raise

    def request(self, method: str, path: str, params: dict | None = None,
                body: bytes | None = None, headers: dict[str, str] | None = None,
                stream: bool = False) -> "ServiceResponse | StreamedServiceResponse":
        """``stream=False`` (default) reads the full body and returns a
        ``ServiceResponse``. ``stream=True`` returns headers-first
        (``StreamedServiceResponse``); the span/metrics/log then cover
        dispatch-to-headers, not the body transfer — the caller owns the
        connection until it exhausts ``iter_content`` or ``close()``s."""
        headers = dict(headers or {})
        span = None
        parent = current_span()
        if self._tracer is not None:
            span = self._tracer.start_span(f"HTTP {method} {self.base_url}", parent=parent,
                                           kind="CLIENT", set_current=False)
            headers.setdefault("traceparent", span.traceparent())
        elif parent is not None:
            headers.setdefault("traceparent", parent.traceparent())
        start = time.perf_counter()
        result = None
        try:
            if stream:
                # identity, FORCED over any caller value (case variants
                # included): iter_content hands out RAW chunks for frame
                # latency, so the wire must not be content-coded
                for k in [k for k in headers if k.lower() == "accept-encoding"]:
                    del headers[k]
                headers["accept-encoding"] = "identity"
                conn, resp = self._open(method, path, params, body, headers, self._timeout)
                result = StreamedServiceResponse(conn, resp)
                return result
            conn, resp = self._open(method, path, params, body, headers, self._timeout)
            try:
                result = ServiceResponse(resp.status, resp.read(), _lower(resp.getheaders()))
            finally:
                conn.close()
            return result
        except _TRANSPORT_ERRORS as e:
            if span is not None:
                span.set_status("ERROR").set_attribute("error", repr(e))
            raise ServiceError(str(e) or repr(e)) from e
        finally:
            duration = time.perf_counter() - start
            status = result.status_code if result is not None else 0
            if span is not None:
                span.set_attribute("http.status_code", status)
                span.finish()
            if self._metrics is not None:
                self._metrics.record_histogram(
                    "app_http_service_response", duration,
                    service=self.base_url, method=method, status=str(status),
                )
            if self._logger is not None:
                self._logger.debug({
                    "message": "http service call", "service": self.base_url,
                    "method": method, "path": path, "status": status,
                    "duration_us": int(duration * 1e6),
                })

    # verb sugar (gofr new.go:35-64)
    def get(self, path: str, params: dict | None = None, headers: dict | None = None) -> ServiceResponse:
        return self.request("GET", path, params=params, headers=headers)

    def post(self, path: str, body: bytes | None = None, params: dict | None = None,
             headers: dict | None = None) -> ServiceResponse:
        return self.request("POST", path, params=params, body=body, headers=headers)

    def put(self, path: str, body: bytes | None = None, params: dict | None = None,
            headers: dict | None = None) -> ServiceResponse:
        return self.request("PUT", path, params=params, body=body, headers=headers)

    def patch(self, path: str, body: bytes | None = None, params: dict | None = None,
              headers: dict | None = None) -> ServiceResponse:
        return self.request("PATCH", path, params=params, body=body, headers=headers)

    def delete(self, path: str, body: bytes | None = None, headers: dict | None = None) -> ServiceResponse:
        return self.request("DELETE", path, body=body, headers=headers)

    def health_check(self, endpoint: str = "/.well-known/alive", timeout: float = 5.0) -> dict[str, Any]:
        try:
            conn, resp = self._open("GET", endpoint, None, None, {}, timeout)
            try:
                resp.read()
            finally:
                conn.close()
            up = 200 <= resp.status < 300
            return {"status": "UP" if up else "DOWN", "details": {"host": self.base_url}}
        except _TRANSPORT_ERRORS as e:
            return {"status": "DOWN", "details": {"host": self.base_url, "error": str(e) or repr(e)}}

    def close(self) -> None:
        self._closed = True


class ServiceError(Exception):
    status_code = 503


class _Wrapper:
    """Base for decorating options: delegates everything to the inner client."""

    def __init__(self, inner):
        self._inner = inner

    def request(self, method: str, path: str, **kw: Any) -> ServiceResponse:
        return self._inner.request(method, path, **kw)

    def get(self, path: str, params: dict | None = None, headers: dict | None = None) -> ServiceResponse:
        return self.request("GET", path, params=params, headers=headers)

    def post(self, path: str, body: bytes | None = None, params: dict | None = None,
             headers: dict | None = None) -> ServiceResponse:
        return self.request("POST", path, params=params, body=body, headers=headers)

    def put(self, path: str, body: bytes | None = None, params: dict | None = None,
            headers: dict | None = None) -> ServiceResponse:
        return self.request("PUT", path, params=params, body=body, headers=headers)

    def patch(self, path: str, body: bytes | None = None, params: dict | None = None,
              headers: dict | None = None) -> ServiceResponse:
        return self.request("PATCH", path, params=params, body=body, headers=headers)

    def delete(self, path: str, body: bytes | None = None, headers: dict | None = None) -> ServiceResponse:
        return self.request("DELETE", path, body=body, headers=headers)

    def health_check(self, **kw: Any) -> dict[str, Any]:
        return self._inner.health_check(**kw)

    def close(self) -> None:
        self._inner.close()

    @property
    def base_url(self) -> str:
        return self._inner.base_url


# -- options -------------------------------------------------------------------


class Retry:
    """Retry on transport error or 5xx (gofr `retry.go:95-109`), with the
    storm-safe refinements of docs/resilience.md:

    - *full jitter* on the exponential backoff — ``uniform(0, backoff *
      2**attempt)`` — so synchronized callers don't re-converge on the
      recovering upstream in lockstep waves;
    - a ``Retry-After`` header on a 429/503 response overrides the
      computed backoff (the server knows its recovery horizon better
      than our exponent does), capped at the remaining deadline when the
      outgoing request carries ``X-Request-Deadline-Ms``;
    - an optional shared :class:`~gofr_tpu_torch.service.budget.RetryBudget`:
      each retry must win a token, and an exhausted budget fails fast
      with the last error instead of amplifying the storm;
    - requests whose propagated deadline has expired stop retrying —
      a retry the caller cannot wait for is pure amplification.
    """

    def __init__(self, max_retries: int = 3, backoff: float = 0.05,
                 budget: Any = None, rng: Any = None):
        self.max_retries = max_retries
        self.backoff = backoff
        self.budget = budget
        self._rng = rng if rng is not None else random.Random()

    def add_option(self, inner):
        opt = self

        class _Retry(_Wrapper):
            def request(self, method: str, path: str, **kw: Any) -> ServiceResponse:
                from gofr_tpu_torch import deadline as _deadline

                headers = kw.get("headers") or {}
                dl = _deadline.parse_deadline_ms(
                    headers.get(_deadline.DEADLINE_HEADER))
                if opt.budget is not None:
                    opt.budget.note_request()
                last_exc: Exception | None = None
                for attempt in range(opt.max_retries + 1):
                    retry_after: float | None = None
                    try:
                        resp = self._inner.request(method, path, **kw)
                        if resp.status_code in (429, 503):
                            # httpx normalizes header keys to lowercase;
                            # hand-built responses may not
                            h = resp.headers or {}
                            ra = h.get("Retry-After") or h.get("retry-after")
                            try:
                                retry_after = float(ra) if ra else None
                            except (TypeError, ValueError):
                                retry_after = None
                        # a 429 WITH a Retry-After hint is retryable — the
                        # server said exactly when; a bare 429 stays the
                        # caller's problem (its rate budget, not ours)
                        if resp.status_code < 500 and not (
                                resp.status_code == 429 and retry_after is not None):
                            return resp
                        resp.close()  # a streamed 5xx must not leak its connection
                        last_exc = ServiceError(f"server error {resp.status_code}")
                    except ServiceError as e:
                        last_exc = e
                    if attempt >= opt.max_retries:
                        break
                    # full jitter unless the server named its own horizon
                    sleep = (retry_after if retry_after is not None
                             else opt._rng.uniform(0.0, opt.backoff * (2 ** attempt)))
                    if dl is not None:
                        remaining = dl - time.monotonic()
                        if remaining <= 0:
                            break  # the caller's budget is spent: stop amplifying
                        sleep = min(sleep, remaining)
                    if opt.budget is not None and not opt.budget.try_spend():
                        break  # shared budget exhausted: fail fast, decay the storm
                    time.sleep(max(0.0, sleep))
                if isinstance(last_exc, ServiceError):
                    raise last_exc
                raise ServiceError("retries exhausted")

        return _Retry(inner)


class CircuitBreaker:
    """Two-state breaker with background health probing while open
    (gofr `circuit_breaker.go`). ``close()`` ends the probe with the
    client (the App closes its services at shutdown); JAX's probe runs
    until the upstream answers."""

    def __init__(self, threshold: int = 5, interval: float = 5.0):
        self.threshold = threshold
        self.interval = interval

    def add_option(self, inner):
        opt = self

        class _CB(_Wrapper):
            def __init__(self, inner):
                super().__init__(inner)
                self._failures = 0
                self._open = False
                self._lock = threading.Lock()
                self._probe: threading.Thread | None = None
                # set by close(): the probe ends with the client
                self._closed = threading.Event()

            def request(self, method: str, path: str, **kw: Any) -> ServiceResponse:
                with self._lock:
                    if self._open:
                        raise ServiceError("circuit breaker is open")
                try:
                    resp = self._inner.request(method, path, **kw)
                except ServiceError:
                    self._record_failure()
                    raise
                if resp.status_code >= 500:
                    self._record_failure()
                else:
                    with self._lock:
                        self._failures = 0
                return resp

            def _record_failure(self) -> None:
                with self._lock:
                    self._failures += 1
                    if self._failures >= opt.threshold and not self._open:
                        self._open = True
                        self._probe = threading.Thread(target=self._probe_loop, daemon=True,
                                                       name="gofr-cb-probe")
                        self._probe.start()

            def _probe_loop(self) -> None:
                while not self._closed.wait(opt.interval):
                    health = self._inner.health_check()
                    if health.get("status") == "UP":
                        with self._lock:
                            self._open = False
                            self._failures = 0
                        return

            @property
            def is_open(self) -> bool:
                with self._lock:
                    return self._open

            def health_check(self, **kw: Any) -> dict[str, Any]:
                h = self._inner.health_check(**kw)
                h.setdefault("details", {})["circuit_open"] = self.is_open
                return h

            def close(self) -> None:
                self._closed.set()
                if self._probe is not None:
                    self._probe.join()
                self._inner.close()

        return _CB(inner)


class BasicAuthOption:
    def __init__(self, username: str, password: str):
        token = base64.b64encode(f"{username}:{password}".encode()).decode()
        self._header = f"Basic {token}"

    def add_option(self, inner):
        return _HeaderInjector(inner, {"Authorization": self._header})


class APIKeyOption:
    def __init__(self, key: str):
        self._key = key

    def add_option(self, inner):
        return _HeaderInjector(inner, {"X-API-KEY": self._key})


class DefaultHeaders:
    def __init__(self, **headers: str):
        self._headers = {k.replace("_", "-"): v for k, v in headers.items()}

    def add_option(self, inner):
        return _HeaderInjector(inner, self._headers)


class _HeaderInjector(_Wrapper):
    def __init__(self, inner, headers: dict[str, str]):
        super().__init__(inner)
        self._headers = headers

    def request(self, method: str, path: str, **kw: Any) -> ServiceResponse:
        headers = dict(kw.pop("headers", None) or {})
        for k, v in self._headers.items():
            headers.setdefault(k, v)
        return self._inner.request(method, path, headers=headers, **kw)


class OAuth2ClientCredentials:
    """Client-credentials flow: fetches and caches a bearer token
    (gofr `oauth.go:14-40`)."""

    def __init__(self, token_url: str, client_id: str, client_secret: str, scopes: list[str] | None = None):
        self.token_url = token_url
        self.client_id = client_id
        self.client_secret = client_secret
        self.scopes = scopes or []
        self._token: str | None = None
        self._expiry = 0.0
        self._lock = threading.Lock()

    def _fetch(self) -> str:
        with self._lock:
            if self._token and time.time() < self._expiry - 30:
                return self._token
            form = urllib.parse.urlencode({
                "grant_type": "client_credentials",
                "client_id": self.client_id,
                "client_secret": self.client_secret,
                "scope": " ".join(self.scopes),
            }).encode()
            with urllib.request.urlopen(urllib.request.Request(self.token_url, data=form),
                                        timeout=10.0) as resp:
                data = json.loads(resp.read())
            self._token = data["access_token"]
            self._expiry = time.time() + float(data.get("expires_in", 3600))
            return self._token

    def add_option(self, inner):
        opt = self

        class _OAuth(_Wrapper):
            def request(self, method: str, path: str, **kw: Any) -> ServiceResponse:
                headers = dict(kw.pop("headers", None) or {})
                headers.setdefault("Authorization", f"Bearer {opt._fetch()}")
                return self._inner.request(method, path, headers=headers, **kw)

        return _OAuth(inner)


def new_http_service(base_url: str, logger=None, metrics=None, *options: Any,
                     tracer=None, timeout: float = 30.0):
    """Build the decorated client: options fold outermost-last (gofr `new.go:68-87`)."""
    client: Any = HTTPService(base_url, logger, metrics, tracer=tracer, timeout=timeout)
    for option in options:
        client = option.add_option(client)
    return client
