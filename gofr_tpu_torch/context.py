"""Context: the transport-neutral handler context (gofr `pkg/gofr/
context.go`), the port's own copy of gofr_tpu/context.py for the HTTP
transport.

The server builds a Context from (request, container) and passes it to the
user handler ``def handler(ctx) -> result``. Handlers reach the request
(``bind``, ``param``, ``path_param``, ``header``), the container
(``logger``, ``config``, ``metrics``, ``publish``) and the served models
(``infer``, ``generate``, ``agenerate``) through it. The request is any
transport's: an HTTP request, a websocket message, a pub/sub message, a gRPC
call or a cron firing's empty request. What each engine call takes from
the request (``_request_kw``, context.py:143-200): the request's server
span (``_parent_span``: the engine hangs its spans under it), the
propagated deadline, the ``X-Adapter-ID`` header, the QoS class the QoS
middleware resolved, and the tracking of the submitted Request, so a
timeout or a client that goes away cancels it. ``ctx.trace(name)`` opens
a user span under the request's.
"""

from __future__ import annotations

import asyncio
from typing import TYPE_CHECKING, Any

from gofr_tpu_torch import deadline as _deadline
from gofr_tpu_torch.http.errors import RequestTimeout
from gofr_tpu_torch.tracing import Span

if TYPE_CHECKING:
    from gofr_tpu_torch.container import Container


class Context:
    __slots__ = ("request", "container", "span", "_engine_requests")

    def __init__(self, request: Any, container: "Container", span: Span | None = None):
        self.request = request
        self.container = container
        self.span = span
        # engine Requests submitted through this context, so the transport
        # can cancel them all when the client disconnects mid-handler;
        # populated via the engine's _on_submit hook
        self._engine_requests: list[Any] = []

    # -- request passthrough ---------------------------------------------------

    def param(self, key: str) -> str:
        return self.request.param(key)

    def params(self, key: str) -> list[str]:
        return self.request.params(key)

    def path_param(self, key: str) -> str:
        return self.request.path_param(key)

    def bind(self, target: Any = dict) -> Any:
        return self.request.bind(target)

    def header(self, key: str) -> str | None:
        headers = getattr(self.request, "headers", None)
        return headers.get(key) if headers else None

    @property
    def claims(self) -> dict[str, Any]:
        """JWT claims the OAuth middleware verified (empty without them)."""
        return self.request.context().get("jwt_claims", {})

    @property
    def auth_user(self) -> str | None:
        return self.request.context().get("auth_user")

    # -- container passthrough -------------------------------------------------

    @property
    def logger(self):
        return self.container.logger

    @property
    def config(self):
        return self.container.config

    @property
    def metrics(self):
        return self.container.metrics

    # -- pub/sub ---------------------------------------------------------------

    def publish(self, topic: str, payload: Any) -> None:
        """Publish through the container's broker; a sampled span's trace
        context rides the message, so the subscriber's span joins it."""
        headers = None
        if self.span is not None and self.span.sampled:
            headers = {"traceparent": self.span.traceparent()}
        self.container.publish(topic, payload, headers=headers)

    # -- model inference -------------------------------------------------------

    def cancel_inflight(self, reason: str = "client_disconnect") -> int:
        """Cancel every engine Request submitted through this context — the
        transport calls this on a timeout or when the client goes away, so
        slots and pages are reclaimed instead of computing for a ghost.
        Returns the number of requests flagged."""
        n = 0
        for r in self._engine_requests:
            if not r.cancelled:
                r.cancel(reason)
                n += 1
        return n

    def _request_kw(self, kw: dict[str, Any]) -> dict[str, Any]:
        """The engine kwargs the request adds (context.py:143-200): the
        server span goes along as the engine's parent span, the remaining
        deadline tightens ``timeout``, the submitted Request is tracked,
        the ``X-Adapter-ID`` header routes to an adapter unless the handler
        named one, and the class the QoS middleware resolved schedules it
        unless the handler set one."""
        if self.span is not None and "_parent_span" not in kw:
            kw["_parent_span"] = self.span
        rem = _deadline.remaining(self.request.context())
        if rem is not None:
            t = kw.get("timeout")
            kw["timeout"] = rem if t is None else min(t, rem)
        kw.setdefault("_on_submit", self._engine_requests.append)
        if "adapter_id" not in kw and "_adapter" not in kw:
            ad = self.header("X-Adapter-ID")
            if ad:
                kw["adapter_id"] = ad
        if "qos_class" not in kw and "_qos_class" not in kw:
            cls = self.request.context().get("qos_class")
            if cls:
                kw["_qos_class"] = cls
        return kw

    def infer(self, model: str, inputs: Any, **kw: Any):
        """Enqueue ``inputs`` on a served model's engine and block until the
        result is ready (the engine runs in its own device thread)."""
        return self.container.infer(model, inputs, **self._request_kw(kw))

    def generate(self, model: str, prompt: Any, max_new_tokens: int = 64, **kw: Any):
        return self.container.generate(
            model, prompt, max_new_tokens=max_new_tokens, **self._request_kw(kw))

    async def agenerate(self, model: str, prompt: Any, max_new_tokens: int = 64, **kw: Any):
        """Generate for ``async def`` handlers: awaits the engine's Request
        through a done callback, so no thread parks per request in flight
        (context.py:208-252). The callback only schedules the resolution
        on the loop, and never touches a loop that has closed."""
        engine = self.container.engine(model)
        kw = self._request_kw(kw)
        timeout = kw.get("timeout", None)
        if timeout is None:
            timeout = getattr(engine, "default_timeout", None)
        req = engine.submit(prompt, max_new_tokens=max_new_tokens, **kw)
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def resolve() -> None:
            if fut.done():
                return
            result, error = req.outcome()
            if error is not None:
                fut.set_exception(error)
            else:
                fut.set_result(result)

        def on_done(_r) -> None:
            try:
                loop.call_soon_threadsafe(resolve)
            except RuntimeError:  # the loop has closed: nobody awaits
                pass

        req.add_done_callback(on_done)
        try:
            # the backstop Request.result() has: a wedged device thread
            # never completes, so the await times out on its own
            if timeout:
                return await asyncio.wait_for(fut, timeout)
            return await fut
        except asyncio.TimeoutError:
            req.cancel("timeout")
            raise RequestTimeout() from None
        except asyncio.CancelledError:
            req.cancel("client_disconnect")
            raise

    # -- tracing ---------------------------------------------------------------

    def trace(self, name: str) -> Span:
        """Open a user span as a child of the request span (gofr
        `context.go:45-55`). Use as a context manager:
        ``with ctx.trace("work"): ...``"""
        return self.container.tracer.start_span(name, parent=self.span)
