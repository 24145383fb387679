"""gRPC server with logging/tracing/panic-recovery interceptor.

Parity with gofr `pkg/gofr/grpc.go:22-27` (chained interceptors: recovery +
logging/tracing) and `pkg/gofr/grpc/log.go` (per-RPC span + structured RPCLog
with method/status/µs). Servicers are generated-protobuf classes registered via
``app.register_grpc_service(add_fn, servicer)``.

The port's own copy of gofr_tpu/grpc/server.py. ``grpc`` is imported inside
the functions that use it, never when the module is imported, so the App
and this module import on an installation without ``grpcio``; the
interceptors implement ``intercept_service`` without subclassing
``grpc.ServerInterceptor``, which grpc's server pipeline does not require.
"""

from __future__ import annotations

import contextvars
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from gofr_tpu_torch.context import Context

_grpc_ctx: contextvars.ContextVar[Context | None] = contextvars.ContextVar("gofr_grpc_ctx", default=None)


def current_grpc_context() -> Context | None:
    """The framework Context for the in-flight RPC (same surface as HTTP
    handlers get — closes the reference's gRPC asymmetry)."""
    return _grpc_ctx.get()


class RPCLog:
    def __init__(self, method: str, status_code: int, duration_us: int, trace_id: str,
                 messages: int | None = None):
        self.method = method
        self.status_code = status_code
        self.duration_us = duration_us
        self.trace_id = trace_id
        self.messages = messages  # response count for streaming RPCs

    def to_log_dict(self) -> dict[str, Any]:
        out = {
            "message": "rpc",
            "method": self.method,
            "status_code": self.status_code,
            "duration_us": self.duration_us,
            "trace_id": self.trace_id,
        }
        if self.messages is not None:
            out["messages"] = self.messages
        return out

    def pretty_print(self, w) -> None:
        extra = f" msgs={self.messages}" if self.messages is not None else ""
        w.write(f"  RPC {self.method} status={self.status_code} {self.duration_us}µs{extra}\n")


class GofrGrpcInterceptor:
    """Recovery + span + RPCLog for ALL four RPC kinds — the reference
    intercepts only unary calls (`grpc.go:24`); here streaming RPCs get the
    same treatment so a streaming handler crash becomes INTERNAL with a
    logged span instead of a bare connection reset."""

    def __init__(self, container):
        self._container = container

    def intercept_service(self, continuation, handler_call_details):
        import grpc

        handler = continuation(handler_call_details)
        if handler is None:
            return handler
        method = handler_call_details.method
        metadata = dict(handler_call_details.invocation_metadata or ())

        dispatch = (
            ("unary_unary", self._wrap_unary, grpc.unary_unary_rpc_method_handler),
            ("unary_stream", self._wrap_stream, grpc.unary_stream_rpc_method_handler),
            ("stream_unary", self._wrap_unary, grpc.stream_unary_rpc_method_handler),
            ("stream_stream", self._wrap_stream, grpc.stream_stream_rpc_method_handler),
        )
        for attr, wrap, factory in dispatch:
            inner = getattr(handler, attr)
            if inner:
                return factory(
                    wrap(inner, method, metadata),
                    request_deserializer=handler.request_deserializer,
                    response_serializer=handler.response_serializer,
                )
        return handler

    def _begin(self, request, method: str, metadata: dict[str, str],
               servicer_context=None):
        container = self._container
        span = container.tracer.start_span(
            f"grpc {method}", traceparent=metadata.get("traceparent"), kind="SERVER",
            set_current=False,
        )
        span.set_attribute("rpc.method", method)
        adapter = _GRPCRequestAdapter(request, metadata)
        if servicer_context is not None:
            # the client's RPC deadline joins the request-lifetime plane
            # (docs/resilience.md): stored as a monotonic deadline on the
            # request context, Context folds the remaining budget into the
            # engine timeout — DEADLINE_EXCEEDED then reflects the CLIENT's
            # budget, not only the server default
            try:
                tr = servicer_context.time_remaining()
            except Exception:  # noqa: BLE001 - non-standard test doubles
                tr = None
            if tr is not None and tr < 3600 * 24 * 365:
                from gofr_tpu_torch import deadline as _deadline

                _deadline.set_deadline(adapter.context(),
                                       time.monotonic() + max(0.0, tr))
        ctx = Context(adapter, container, span=span)
        token = _grpc_ctx.set(ctx)
        return span, token

    def _end(self, span, token, method: str, status: int, start: float,
             messages: int | None = None) -> None:
        try:
            _grpc_ctx.reset(token)
        except ValueError:
            # a cancelled stream generator can be finalized by the GC on a
            # different thread; the token belongs to the serving thread's
            # context then. The span/log below must still run.
            pass
        span.set_attribute("rpc.status_code", status)
        if messages is not None:
            span.set_attribute("rpc.messages", messages)
        span.finish()
        self._container.logger.info(
            RPCLog(method, status, int((time.perf_counter() - start) * 1e6),
                   span.trace_id, messages=messages)
        )

    def _wrap_unary(self, inner, method: str, metadata: dict[str, str]):
        import grpc

        container = self._container

        def wrapped(request, servicer_context):
            span, token = self._begin(request, method, metadata, servicer_context)
            start = time.perf_counter()
            status = 0
            try:
                return inner(request, servicer_context)
            except Exception as e:  # noqa: BLE001 - panic recovery → typed code or INTERNAL
                code = _grpc_code_of(e)
                status = code.value[0]
                span.set_status("ERROR")
                if code is grpc.StatusCode.INTERNAL:
                    container.logger.log_exception(e, f"grpc handler {method}")
                    servicer_context.abort(grpc.StatusCode.INTERNAL, "internal error")
                else:
                    # typed (QoS/timeout) rejection: retryable status + hint,
                    # no stack spam — rejection under load is not a fault
                    _abort_typed(servicer_context, e, code)
            finally:
                self._end(span, token, method, status, start)

        return wrapped

    def _wrap_stream(self, inner, method: str, metadata: dict[str, str]):
        import grpc

        container = self._container

        def wrapped(request, servicer_context):
            span, token = self._begin(request, method, metadata, servicer_context)
            start = time.perf_counter()
            status = 0
            sent = 0
            try:
                for item in inner(request, servicer_context):
                    sent += 1
                    yield item
            except GeneratorExit:
                # client cancelled mid-stream — log it as CANCELLED, not OK,
                # so cancellation storms are visible in logs/traces
                status = 1  # grpc CANCELLED
                span.set_status("CANCELLED")
                raise
            except Exception as e:  # noqa: BLE001 - panic recovery → typed code or INTERNAL
                code = _grpc_code_of(e)
                status = code.value[0]
                span.set_status("ERROR")
                if code is grpc.StatusCode.INTERNAL:
                    container.logger.log_exception(e, f"grpc stream handler {method}")
                    servicer_context.abort(grpc.StatusCode.INTERNAL, "internal error")
                else:
                    _abort_typed(servicer_context, e, code)
            finally:
                self._end(span, token, method, status, start, messages=sent)

        return wrapped


def _grpc_code_of(e: Exception):
    """Map typed HTTP errors to gRPC codes so QoS rejections raised inside
    handlers (engine admission: 429/503) surface as retryable statuses
    instead of INTERNAL."""
    import grpc

    sc = getattr(e, "status_code", None)
    if sc == 429:
        return grpc.StatusCode.RESOURCE_EXHAUSTED
    if sc == 503:
        return grpc.StatusCode.UNAVAILABLE
    if sc in (408, 504):
        # 408 = server-side timeout, 504 = the client's propagated deadline
        # was unmeetable (sheds with reason deadline_exceeded) — both are
        # DEADLINE_EXCEEDED on the wire
        return grpc.StatusCode.DEADLINE_EXCEEDED
    return grpc.StatusCode.INTERNAL


def _abort_typed(servicer_context, e: Exception, code) -> None:
    from gofr_tpu_torch.http.errors import retry_after_hint

    retry_after = getattr(e, "retry_after", None)
    if retry_after is not None:
        servicer_context.set_trailing_metadata(
            (("retry-after", retry_after_hint(retry_after)),))
    servicer_context.abort(code, str(e) or code.name.lower().replace("_", " "))


class QoSGrpcInterceptor:
    """Transport-edge admission control for gRPC (the 429/503 analog):
    over-rate traffic aborts RESOURCE_EXHAUSTED, backlog shedding aborts
    UNAVAILABLE, both with ``retry-after`` trailing metadata — the request
    never reaches the servicer or the model engine. Ordered OUTSIDE the
    Gofr interceptor so a rejection is not re-wrapped into INTERNAL."""

    def __init__(self, container):
        self._container = container

    def intercept_service(self, continuation, handler_call_details):
        import grpc

        handler = continuation(handler_call_details)
        controller = getattr(self._container, "qos", None)
        if handler is None or controller is None:
            return handler
        method = handler_call_details.method
        metadata = dict(handler_call_details.invocation_metadata or ())

        def check(servicer_context) -> None:
            decision = controller.admit_transport(
                route=method,
                api_key=metadata.get("x-api-key", ""),
                tenant=metadata.get(controller.policy.tenant_header.lower(), ""),
                cls_name=metadata.get(controller.policy.class_header.lower()),
            )
            if not decision.allowed:
                from gofr_tpu_torch.http.errors import retry_after_hint

                servicer_context.set_trailing_metadata(
                    (("retry-after", retry_after_hint(decision.retry_after)),))
                code = (grpc.StatusCode.RESOURCE_EXHAUSTED if decision.status == 429
                        else grpc.StatusCode.UNAVAILABLE)
                servicer_context.abort(code, decision.message)

        def wrap_unary(inner):
            def wrapped(request, servicer_context):
                check(servicer_context)
                return inner(request, servicer_context)
            return wrapped

        def wrap_stream(inner):
            def wrapped(request, servicer_context):
                check(servicer_context)
                yield from inner(request, servicer_context)
            return wrapped

        dispatch = (
            ("unary_unary", wrap_unary, grpc.unary_unary_rpc_method_handler),
            ("unary_stream", wrap_stream, grpc.unary_stream_rpc_method_handler),
            ("stream_unary", wrap_unary, grpc.stream_unary_rpc_method_handler),
            ("stream_stream", wrap_stream, grpc.stream_stream_rpc_method_handler),
        )
        for attr, wrap, factory in dispatch:
            inner = getattr(handler, attr)
            if inner:
                return factory(
                    wrap(inner),
                    request_deserializer=handler.request_deserializer,
                    response_serializer=handler.response_serializer,
                )
        return handler


class _GRPCRequestAdapter:
    """Request-interface adapter over a protobuf message."""

    def __init__(self, message, metadata: dict[str, str]):
        self.message = message
        self.metadata = metadata
        self._ctx: dict[str, Any] = {}

    def param(self, key: str) -> str:
        return str(self.metadata.get(key, ""))

    def params(self, key: str) -> list[str]:
        v = self.param(key)
        return [v] if v else []

    def path_param(self, key: str) -> str:
        # gRPC has no path; metadata is the closest analog, so handlers
        # written against the HTTP Context shape still resolve something
        return str(self.metadata.get(key, ""))

    def bind(self, target: Any = None) -> Any:
        """No target → the raw message (protobuf or decoded JSON); a
        JSON-shaped message coerces through the SAME binder as the HTTP
        path (`http/request.py:95`), so dataclass/annotated-class targets
        behave identically across transports."""
        if target is None:
            return self.message
        if isinstance(self.message, (dict, list, str, int, float, bool)):
            from gofr_tpu_torch.utils import bind as binder

            return binder.bind(self.message, target)
        return self.message  # protobuf message: handler works with it directly

    def host_name(self) -> str:
        return "grpc"

    def context(self) -> dict[str, Any]:
        return self._ctx


def start_grpc_server(app):
    """Start the App's gRPC server on ``GRPC_PORT`` (0 binds a free port,
    which ``app.grpc_port`` then reads) with ``GRPC_THREADS`` handler
    threads (``server.gofr_pool``), the QoS interceptor outermost; raises
    when the port cannot be bound."""
    import grpc

    interceptors: list[Any] = []
    if getattr(app.container, "qos", None) is not None:
        # outermost: a QoS rejection aborts before the Gofr wrapper (which
        # would log it as INTERNAL) or the servicer ever runs
        interceptors.append(QoSGrpcInterceptor(app.container))
    interceptors.append(GofrGrpcInterceptor(app.container))
    pool = ThreadPoolExecutor(max_workers=app.config.get_int("GRPC_THREADS", 16),
                              thread_name_prefix="gofr-grpc")
    server = grpc.server(pool, interceptors=interceptors)
    # the handler pool, which grpc's stop leaves running: the App shuts it
    # down after the server
    server.gofr_pool = pool
    for adder, servicer in app._grpc_services:
        if servicer is not None:
            adder(servicer, server)
        elif callable(adder):
            adder(server)
    port = server.add_insecure_port(f"[::]:{app.grpc_port}")
    if not port:
        raise RuntimeError(f"gRPC server could not bind port {app.grpc_port}")
    app.grpc_port = port
    server.start()
    return server
