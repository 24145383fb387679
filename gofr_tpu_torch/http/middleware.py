"""HTTP middleware chain (the port's own copy of the logging, CORS and
metrics middlewares of gofr_tpu/http/middleware/__init__.py, written
against ``http/server.py``'s middleware signature instead of aiohttp's).

Order (outermost first), as the JAX App builds it (app.py:357-363) less
the tracer: logging → CORS → metrics → handler. The tracer, auth and QoS
middlewares are not ported yet.
"""

from __future__ import annotations

import time
import traceback
import uuid
from typing import Any, Callable

from gofr_tpu_torch.http.server import Handler, ServerRequest, ServerResponse
from gofr_tpu_torch.http.responder import to_json


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
        correlation = uuid.uuid4().hex  # the trace id, once a tracer is ported
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
                "trace_id": "",
                "uri": request.path_qs,
            })
            if request.stream is not None:
                raise  # the status line is on the wire already
            response = ServerResponse(
                500, to_json({"error": {"message": "some unexpected error has occurred"}}))
        response.headers["X-Correlation-ID"] = correlation
        duration_us = int((time.perf_counter() - start) * 1e6)
        log_fn = logger.info if response.status < 500 else logger.error
        log_fn(RequestLog("", "", request.method, request.path_qs, response.status,
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
