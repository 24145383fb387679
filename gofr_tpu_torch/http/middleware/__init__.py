"""HTTP middleware chain (the port's own copy of gofr_tpu/http/
middleware/__init__.py, written against ``http/server.py``'s middleware
signature instead of aiohttp's).

Order (outermost first), as the JAX App builds it (app.py:273-286):
tracer → logging → CORS → metrics → QoS (when enabled) → handler. The
tracer middleware opens the request's server span (inbound
``traceparent`` honoured, ``X-Trace-Id`` on the response) and hands it on
in ``request.state``, where logging fills its ``trace_id`` / ``span_id``
and the route handler passes it to the engine. The auth middlewares
(``auth.py``) go after QoS, so shed load never pays the auth path.
"""

from __future__ import annotations

import time
import traceback
import uuid
from typing import Any, Callable

from gofr_tpu_torch.http.errors import retry_after_hint
from gofr_tpu_torch.http.request import _CIDict
from gofr_tpu_torch.http.server import Handler, ServerRequest, ServerResponse
from gofr_tpu_torch.http.responder import to_json
from gofr_tpu_torch.tracing import Tracer

# ``ServerRequest.state`` keys (the JAX middlewares' request keys)
SPAN_KEY = "gofr_span"
QOS_KEY = "gofr_qos_class"


def tracer_middleware(tracer: Tracer):
    """A SERVER span per request, joined to an inbound ``traceparent``;
    its trace id goes back as ``X-Trace-Id`` (http/middleware/__init__.py:
    27-52)."""

    async def mw(request: ServerRequest, handler: Handler) -> ServerResponse:
        span = tracer.start_span(f"{request.method} {request.path}",
                                 traceparent=request.headers.get("traceparent"), kind="SERVER",
                                 set_current=False)
        span.set_attribute("http.method", request.method)
        span.set_attribute("http.target", request.path_qs)
        request.state[SPAN_KEY] = span
        try:
            response = await handler(request)
            span.set_attribute("http.status_code", response.status)
            # clients (and support tickets) can quote the trace without a
            # propagation-aware client library
            response.headers.setdefault("X-Trace-Id", span.trace_id)
            return response
        except Exception:
            span.set_status("ERROR")
            raise
        finally:
            span.finish()

    return mw


class RequestLog:
    """Structured request record with custom terminal rendering
    (gofr `middleware/logger.go:110-122`)."""

    def __init__(self, trace_id: str, span_id: str, method: str, uri: str,
                 status: int, duration_us: int, ip: str):
        self.trace_id = trace_id
        self.span_id = span_id
        self.method = method
        self.uri = uri
        self.status = status
        self.duration_us = duration_us
        self.ip = ip

    def to_log_dict(self) -> dict[str, Any]:
        return {
            "message": "request",
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "method": self.method,
            "uri": self.uri,
            "status": self.status,
            "duration_us": self.duration_us,
            "ip": self.ip,
        }

    def pretty_print(self, w) -> None:
        color = 32 if self.status < 400 else (33 if self.status < 500 else 31)
        w.write(
            f"  \x1b[{color}m{self.status}\x1b[0m {self.method:<7} {self.uri} "
            f"{self.duration_us}µs trace={self.trace_id}\n"
        )


def logging_middleware(logger):
    """One ``RequestLog`` per request (errors at ERROR), an
    ``X-Correlation-ID`` header, and a handler's exception turned into the
    JSON 500 (logger.go:129-152)."""

    async def mw(request: ServerRequest, handler: Handler) -> ServerResponse:
        start = time.perf_counter()
        span = request.state.get(SPAN_KEY)
        trace_id = span.trace_id if span else ""
        span_id = span.span_id if span else ""
        correlation = trace_id or uuid.uuid4().hex
        ip = request.headers.get("x-forwarded-for", request.remote)
        if "," in ip:
            ip = ip.split(",")[0].strip()
        try:
            response = await handler(request)
        except Exception as exc:  # noqa: BLE001 - panic recovery
            logger.error({
                "message": "panic recovered",
                "error": repr(exc),
                "stack": traceback.format_exc(),
                "trace_id": trace_id,
                "uri": request.path_qs,
            })
            if request.stream is not None or request.websocket is not None:
                raise  # the status line is on the wire already
            response = ServerResponse(
                500, to_json({"error": {"message": "some unexpected error has occurred"}}))
        response.headers["X-Correlation-ID"] = correlation
        duration_us = int((time.perf_counter() - start) * 1e6)
        log_fn = logger.info if response.status < 500 else logger.error
        log_fn(RequestLog(trace_id, span_id, request.method, request.path_qs, response.status,
                          duration_us, ip))
        return response

    return mw


def cors_middleware(config, registered_methods: Callable[[], list[str]]):
    def _hdr(name: str, default: str) -> str:
        return config.get_or_default(name, default) if config else default

    async def mw(request: ServerRequest, handler: Handler) -> ServerResponse:
        if request.method == "OPTIONS":
            response = ServerResponse(200, content_type=None)
        else:
            response = await handler(request)
        methods = _hdr("ACCESS_CONTROL_ALLOW_METHODS", ", ".join(registered_methods()))
        response.headers.setdefault("Access-Control-Allow-Origin", _hdr("ACCESS_CONTROL_ALLOW_ORIGIN", "*"))
        response.headers.setdefault("Access-Control-Allow-Methods", methods)
        response.headers.setdefault(
            "Access-Control-Allow-Headers",
            _hdr("ACCESS_CONTROL_ALLOW_HEADERS", "Authorization, Content-Type, x-requested-with, X-API-KEY"),
        )
        return response

    return mw


def metrics_middleware(metrics):
    """``app_http_response`` (seconds) by route template, method and
    status; a streamed response counts once its stream has ended."""

    async def mw(request: ServerRequest, handler: Handler) -> ServerResponse:
        start = time.perf_counter()
        status = 500
        try:
            response = await handler(request)
            status = response.status
            return response
        finally:
            metrics.record_histogram(
                "app_http_response", time.perf_counter() - start,
                path=request.route_template, method=request.method, status=str(status),
            )

    return mw


def qos_middleware(controller):
    """Admission at the transport edge (http/middleware/__init__.py:150-191):
    rate limits and backlog shedding answer 429/503 with ``Retry-After``
    and the JSON envelope BEFORE the handler (and so the engine) sees the
    request. The resolved class rides ``request.state`` so
    ``ctx.generate`` / ``ctx.agenerate`` schedule it without the handler's
    help. Well-known routes always pass: a load balancer probing an
    overloaded instance must still see its health."""

    async def mw(request: ServerRequest, handler: Handler) -> ServerResponse:
        if request.path.startswith("/.well-known/") or request.path == "/favicon.ico":
            return await handler(request)
        headers = _CIDict(dict(request.raw_headers))
        cls_name = controller.classify(headers)
        span = request.state.get(SPAN_KEY)
        if span is not None:
            # a shed request's span shows WHY it never reached the engine
            span.set_attribute("qos.class", cls_name)
        decision = controller.admit_transport(
            route=request.route_template,
            api_key=headers.get("X-API-KEY", ""),
            tenant=headers.get(controller.policy.tenant_header, ""),
            cls_name=cls_name,
        )
        if not decision.allowed:
            if span is not None:
                span.set_attribute("qos.rejected", decision.reason)
            return ServerResponse(decision.status,
                                  to_json({"error": {"message": decision.message}}),
                                  headers={"Retry-After": retry_after_hint(decision.retry_after)})
        request.state[QOS_KEY] = cls_name
        return await handler(request)

    return mw
