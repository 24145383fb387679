"""App facade: build the servers from config, register routes, run them
(the port's own copy of gofr_tpu/app.py for HTTP serving).

``App`` owns the HTTP server (logging → CORS → metrics middlewares), the
metrics server on its own port and one Container, and serves handlers
through ``Context``. ``app.serve_model(...)`` registers a continuous-batching
engine on the container; handlers then call ``ctx.agenerate`` /
``ctx.generate`` / ``ctx.infer``. Both servers are ``http/server.py`` on the
standard library, where the JAX App runs aiohttp.

Differences from the JAX App: the engine's device thread starts when the
engine is built, so ``/.well-known/health`` reads UP before ``arun`` (the
JAX App starts its engines in ``arun`` and reads DEGRADED until then);
``HTTP_PORT`` / ``METRICS_PORT`` 0 bind a free port, which ``http_port`` /
``metrics_port`` then read. Not ported yet: websocket routes
(``App.websocket``), the tracer, auth and QoS middlewares, static files,
the OpenAPI and ``/debug/*`` routes, gRPC, pub/sub, cron and the CLI.
"""

from __future__ import annotations

import asyncio
import inspect
import signal
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

from gofr_tpu_torch import deadline
from gofr_tpu_torch.config import DictConfig, EnvConfig
from gofr_tpu_torch.container import Container, new_mock_container
from gofr_tpu_torch.context import Context
from gofr_tpu_torch.http.errors import DeadlineExceeded, RequestTimeout
from gofr_tpu_torch.http.middleware import cors_middleware, logging_middleware, metrics_middleware
from gofr_tpu_torch.http.request import HTTPRequest
from gofr_tpu_torch.http.responder import respond, to_json
from gofr_tpu_torch.http.server import HTTPServer, Router, ServerRequest, ServerResponse
from gofr_tpu_torch.http.streaming import StreamingResponse

Handler = Callable[[Context], Any]


def _json(data: Any, status: int = 200) -> ServerResponse:
    return ServerResponse(status, to_json(data))


class App:
    def __init__(self, config_folder: str = "./configs", config=None, container: Container | None = None):
        self.config = config if config is not None else EnvConfig(folder=config_folder)
        self.container = container if container is not None else Container.create(self.config)
        self.logger = self.container.logger

        self.http_port = self.config.get_int("HTTP_PORT", 8000)
        self.metrics_port = self.config.get_int("METRICS_PORT", 2121)
        self.request_timeout = self.config.get_float("REQUEST_TIMEOUT", 0.0)

        self._routes: list[tuple[str, str, Handler]] = []
        self._executor = ThreadPoolExecutor(
            max_workers=self.config.get_int("HANDLER_THREADS", 32), thread_name_prefix="gofr-handler"
        )
        self._shutdown = asyncio.Event()
        self._servers: list[HTTPServer] = []

    # -- route registration (gofr.go:244-276) ----------------------------------

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self._routes.append((method.upper(), path, handler))

    def get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)

    def post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    def put(self, path: str, handler: Handler) -> None:
        self.add_route("PUT", path, handler)

    def patch(self, path: str, handler: Handler) -> None:
        self.add_route("PATCH", path, handler)

    def delete(self, path: str, handler: Handler) -> None:
        self.add_route("DELETE", path, handler)

    # -- model serving ---------------------------------------------------------

    def serve_model(self, name: str, spec: Any = None, *, engine: Any = None, **engine_kw: Any):
        """Attach a model to the app behind a continuous-batching engine.

        ``spec`` is a ``models.ModelSpec``, built into an engine by
        ``gpu.engine.build_engine(spec, container, **engine_kw)`` (the
        container's ``ENGINE_*`` / ``ADAPTER_*`` config, ``engine_kw``
        winning; on the card unless ``device`` says otherwise); or pass a
        prebuilt ``engine``. Handlers reach it as ``ctx.agenerate(name,
        ...)`` / ``ctx.generate(name, ...)``. If the engine cannot be built,
        this raises: there is no fallback."""
        if engine is None:
            from gofr_tpu_torch.gpu.engine import build_engine

            engine = build_engine(spec, self.container, **engine_kw)
        self.container.register_engine(name, engine)
        return engine

    # -- assembly --------------------------------------------------------------

    def _registered_methods(self) -> list[str]:
        return sorted({m for m, _, _ in self._routes} | {"OPTIONS"})

    def _build_http_server(self) -> HTTPServer:
        router = Router(self._not_found_handler)
        # well-known routes (gofr.go:155-163)
        router.add("GET", "/.well-known/health", self._health_handler)
        router.add("GET", "/.well-known/alive", self._alive_handler)
        router.add("GET", "/favicon.ico", self._favicon_handler)
        for method, path, handler in self._routes:
            router.add(method, path, self._wrap(handler))
        middlewares = [
            logging_middleware(self.logger),
            cors_middleware(self.config, self._registered_methods),
            metrics_middleware(self.container.metrics),
        ]
        return HTTPServer(router, middlewares, on_error=self._on_server_error)

    def _build_metrics_server(self) -> HTTPServer:
        async def metrics_handler(_request: ServerRequest) -> ServerResponse:
            text = self.container.metrics.expose_text()
            return ServerResponse(200, text.encode(), content_type="text/plain; charset=utf-8")

        router = Router(self._not_found_handler)
        router.add("GET", "/metrics", metrics_handler)
        return HTTPServer(router, on_error=self._on_server_error)

    def _on_server_error(self, e: BaseException) -> None:
        self.logger.log_exception(e, "http server")

    # -- request pipeline ------------------------------------------------------

    @staticmethod
    def _materialize(request: ServerRequest) -> HTTPRequest:
        req = HTTPRequest(
            method=request.method,
            path=request.path,
            query_string=request.query_string,
            headers=dict(request.raw_headers),
            body=request.body,
            path_params=request.path_params,
            route_template=request.route_template,
        )
        # the client's absolute deadline, converted once to the monotonic
        # domain; ctx folds the remaining budget into the engine timeout
        deadline.set_deadline(
            req.context(), deadline.parse_deadline_ms(req.headers.get(deadline.DEADLINE_HEADER)))
        # when the server accepted the connection and had read the request
        # (monotonic), for a handler that breaks its latency down
        req.context().update(accepted_at=request.accepted_at, read_at=request.read_at)
        return req

    def _wrap(self, handler: Handler):
        """The route handler around a user handler (app.py:443-514): async
        handlers run on the loop, sync ones on the executor, within the
        tighter of ``REQUEST_TIMEOUT`` and the client's propagated deadline;
        on a timeout the engine work the handler submitted is cancelled."""
        is_coro = inspect.iscoroutinefunction(handler)

        async def route_handler(request: ServerRequest) -> ServerResponse:
            req = self._materialize(request)
            ctx = Context(req, self.container)
            result, err = None, None
            remaining = deadline.remaining(req.context())
            deadline_bound = False
            if remaining is not None and remaining <= 0:
                err = DeadlineExceeded("request deadline already expired")
                remaining = None
            budget = self.request_timeout if self.request_timeout > 0 else None
            if remaining is not None and (budget is None or remaining < budget):
                budget, deadline_bound = remaining, True
            try:
                if err is None:
                    if is_coro:
                        coro = handler(ctx)
                    else:
                        coro = asyncio.get_running_loop().run_in_executor(self._executor, handler, ctx)
                    if budget is not None:
                        result = await asyncio.wait_for(coro, timeout=budget)
                    else:
                        result = await coro
            except asyncio.TimeoutError:
                if deadline_bound:
                    ctx.cancel_inflight("deadline")
                    err = DeadlineExceeded()
                else:
                    ctx.cancel_inflight("timeout")
                    err = RequestTimeout()
            except asyncio.CancelledError:
                ctx.cancel_inflight("client_disconnect")
                raise
            except Exception as e:  # noqa: BLE001
                err = e
                if not hasattr(e, "status_code"):
                    self.logger.log_exception(e, f"handler {request.method} {request.path}")
            if err is None and isinstance(result, StreamingResponse):
                return await self._stream_sse(request, result)
            wire = respond(result, err, request.method)
            return ServerResponse(wire.status, wire.body, content_type=wire.content_type,
                                  headers=wire.headers)

        return route_handler

    async def _stream_sse(self, request: ServerRequest, stream: StreamingResponse) -> ServerResponse:
        """Drive a StreamingResponse as text/event-stream (app.py:516-557).
        Items are pulled on the executor (the engine's stream queue
        blocks); each chunk is flushed, so the token is on the wire before
        generation finishes. A client that went away cancels the
        generation, so the engine frees the slot instead of decoding for a
        ghost; a failure mid-stream becomes an ``event: error`` frame."""
        headers = {"Content-Type": "text/event-stream", "Cache-Control": "no-cache",
                   "X-Accel-Buffering": "no"}
        loop = asyncio.get_running_loop()
        sentinel = object()
        out = None
        try:
            out = await request.prepare_stream(200, headers)
            while True:
                item = await loop.run_in_executor(self._executor, next, stream.iterator, sentinel)
                if item is sentinel:
                    break
                await out.write(stream.encode_sse(item))
            await out.write(StreamingResponse.sse_done())
            await out.write_eof()
        except (ConnectionError, asyncio.CancelledError):
            self._cancel_stream(stream)
            raise
        except Exception as e:  # noqa: BLE001 - surface mid-stream failure in-band
            self.logger.log_exception(e, "sse stream")
            self._cancel_stream(stream)
            if out is None:
                raise
            try:
                await out.write(StreamingResponse.sse_error(str(e)))
                await out.write_eof()
            except Exception:  # noqa: BLE001 - client already gone
                pass
        return ServerResponse(200, content_type="text/event-stream", headers=headers,
                              streamed=True)

    @staticmethod
    def _cancel_stream(stream: StreamingResponse) -> None:
        cancel = getattr(stream.iterator, "cancel", None)
        if callable(cancel):
            cancel()

    # -- built-in handlers -----------------------------------------------------

    async def _health_handler(self, _request: ServerRequest) -> ServerResponse:
        health = await asyncio.get_running_loop().run_in_executor(self._executor, self.container.health)
        return _json({"data": health}, 200 if health["status"] != "DOWN" else 503)

    async def _alive_handler(self, _request: ServerRequest) -> ServerResponse:
        return _json({"data": {"status": "UP"}})

    async def _favicon_handler(self, _request: ServerRequest) -> ServerResponse:
        return ServerResponse(200, b"", content_type="image/x-icon")

    async def _not_found_handler(self, _request: ServerRequest) -> ServerResponse:
        return _json({"error": {"message": "route not registered"}}, 404)

    # -- run -------------------------------------------------------------------

    def run(self) -> None:
        """Start every configured server; blocks until SIGINT/SIGTERM."""
        try:
            asyncio.run(self.arun())
        except KeyboardInterrupt:
            pass

    async def arun(self, ready: asyncio.Event | None = None) -> None:
        """Serve until ``stop()``: the metrics server on ``METRICS_PORT``,
        the HTTP server on ``HTTP_PORT`` when a route is registered; then
        ``ready`` is set. On the way out the servers close, the container
        stops the engines, and the executor shuts down."""
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, self._shutdown.set)
            except (NotImplementedError, RuntimeError, ValueError):
                pass
        try:
            metrics = self._build_metrics_server()
            await metrics.start(port=self.metrics_port)
            self._servers.append(metrics)
            self.metrics_port = metrics.port
            self.logger.infof("metrics server on :%d/metrics", self.metrics_port)
            if self._routes:
                http = self._build_http_server()
                await http.start(port=self.http_port)
                self._servers.append(http)
                self.http_port = http.port
                self.logger.infof("HTTP server on :%d", self.http_port)
            if ready is not None:
                ready.set()
            await self._shutdown.wait()
            self.logger.info("shutting down")
        finally:
            for server in self._servers:
                await server.close()
            self._servers = []
            self.container.close()
            self._executor.shutdown(wait=False, cancel_futures=True)

    def stop(self) -> None:
        self._shutdown.set()


def new_testing(config: dict[str, str] | None = None) -> App:
    """App wired to a mock container for tests."""
    return App(config=DictConfig(config or {}), container=new_mock_container(config))
