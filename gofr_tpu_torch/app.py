"""App facade: build the servers from config, register routes, run them
(the port's own copy of gofr_tpu/app.py).

``App`` owns the HTTP server (tracer → logging → CORS → metrics → QoS →
auth middlewares), the metrics server on its own port, the gRPC server, the
pub/sub subscription manager, the cron table and one Container, and serves
handlers through ``Context``. ``app.serve_model(...)`` registers a
continuous-batching engine on the container; handlers then call
``ctx.agenerate`` / ``ctx.generate`` / ``ctx.infer``. Both servers are
``http/server.py`` on the standard library, where the JAX App runs
aiohttp.

Differences from the JAX App: the engine's device thread starts when the
engine is built, so ``/.well-known/health`` reads UP before ``arun`` (the
JAX App starts its engines in ``arun`` and reads DEGRADED until then);
``HTTP_PORT`` / ``METRICS_PORT`` 0 bind a free port, which ``http_port`` /
``metrics_port`` then read.

The request planes, under the JAX App's config keys: ``TRACE_EXPORTER``
(the tracer middleware's server span, the engine's spans under it),
``QOS_ENABLED`` / ``QOS_*`` (``enable_qos``: 429/503 with
``Retry-After`` before the handler, weighted-fair scheduling in the
engine), ``SLO_ENABLED`` / ``SLO_*`` (attainment and burn gauges, health
DEGRADED on a burn; ``SLO_CAPTURE*``, the burn-breach capture bundles),
and under ``APP_ENV=DEBUG`` the flight recorder's ``/debug/requests`` and
``/debug/engine``, the perf plane's ``/debug/perf`` (with a role worker's
handoff counters), the quality plane's ``/debug/quality``, the step
controller's ``/debug/control`` and ``/debug/profile?seconds=N``, a
``torch.profiler`` Chrome trace under ``PROFILER_DIR`` (one at a time: 409
while one runs). ``ENGINE_WARMUP=true`` warms every engine
(``GenerateEngine.warmup``, with its split-plan autotuner) before the
servers start; ``/debug/engine`` and ``/debug/perf`` show each engine's
``autotune`` report.

The other entry points, each feeding the engines through the same
``Context``: ``websocket`` routes (RFC 6455 on the stdlib server; a
``StreamingResponse`` goes out one frame per token, then ``{"done":
true}``), ``enable_basic_auth`` / ``enable_api_key_auth`` (each
``_with_validator``), ``enable_oauth`` (RS256 through a JWKS endpoint) and
``enable_jwt_hs256``, ``add_static_files``, ``/.well-known/openapi.json``
and ``/.well-known/swagger``, ``register_grpc_service`` (``GRPC_PORT``, 0
binds a free port that ``grpc_port`` then reads; ``GRPC_THREADS``),
``subscribe`` (``SUBSCRIBER_WORKERS`` consumer threads a topic in
``CONSUMER_GROUP``, a message committed only when its handler succeeds)
and ``add_cron_job``. Not ported yet: JAX's ``jax.profiler`` server on
``PROFILER_PORT`` (it has no torch counterpart), the ``pubsub.commit`` and
``client.disconnect`` chaos points, the raw proxy stream and the CLI.
"""

from __future__ import annotations

import asyncio
import inspect
import math
import os
import signal
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable
from urllib.parse import parse_qs

from gofr_tpu_torch import deadline
from gofr_tpu_torch.config import DictConfig, EnvConfig
from gofr_tpu_torch.container import Container, new_mock_container
from gofr_tpu_torch.context import Context
from gofr_tpu_torch.http.errors import DeadlineExceeded, RequestTimeout
from gofr_tpu_torch.http.middleware import (
    QOS_KEY,
    SPAN_KEY,
    cors_middleware,
    logging_middleware,
    metrics_middleware,
    qos_middleware,
    tracer_middleware,
)
from gofr_tpu_torch.http.middleware.auth import AUTH_KEY
from gofr_tpu_torch.http.request import HTTPRequest
from gofr_tpu_torch.http.responder import respond, to_json
from gofr_tpu_torch.http.server import HTTPServer, Router, ServerRequest, ServerResponse
from gofr_tpu_torch.http.streaming import StreamingResponse
from gofr_tpu_torch.metrics import perf as perf_mod
from gofr_tpu_torch.metrics.slo import record_trace
from gofr_tpu_torch.websocket import ConnectionHub, WSConnection

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
        self.grpc_port = self.config.get_int("GRPC_PORT", 9000)
        self.request_timeout = self.config.get_float("REQUEST_TIMEOUT", 0.0)

        self._routes: list[tuple[str, str, Handler]] = []
        self._ws_routes: list[tuple[str, Handler]] = []
        self._static: list[tuple[str, str]] = []
        self._auth_middlewares: list[Any] = []
        self._jwks: list[Any] = []  # JWKS pollers, stopped with the app
        self._subscriptions: dict[str, Handler] = {}
        self._grpc_services: list[Any] = []
        self._executor = ThreadPoolExecutor(
            max_workers=self.config.get_int("HANDLER_THREADS", 32), thread_name_prefix="gofr-handler"
        )
        self.ws_hub = ConnectionHub()

        from gofr_tpu_torch.cron import Crontab

        self.cron = Crontab(self.container)
        if self.config.get_bool("QOS_ENABLED"):
            self.enable_qos()
        self._shutdown = asyncio.Event()
        self._servers: list[HTTPServer] = []
        self._sub_threads: list[threading.Thread] = []
        self._sub_stop = threading.Event()
        # one /debug/profile capture at a time (409 while held)
        self._profile_busy = threading.Lock()

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

    def websocket(self, path: str, handler: Handler) -> None:
        self._ws_routes.append((path, handler))

    def add_static_files(self, route: str, directory: str) -> None:
        self._static.append((route if route.startswith("/") else f"/{route}", directory))

    # -- auth (gofr.go:436-507; app.py:120-155) ---------------------------------

    def enable_basic_auth(self, users: dict[str, str]) -> None:
        from gofr_tpu_torch.http.middleware.auth import basic_auth_middleware

        self._auth_middlewares.append(basic_auth_middleware(users=users))

    def enable_basic_auth_with_validator(self, validator: Callable[..., bool]) -> None:
        from gofr_tpu_torch.http.middleware.auth import basic_auth_middleware

        self._auth_middlewares.append(basic_auth_middleware(validator=validator,
                                                            container=self.container))

    def enable_api_key_auth(self, *keys: str) -> None:
        from gofr_tpu_torch.http.middleware.auth import apikey_auth_middleware

        self._auth_middlewares.append(apikey_auth_middleware(keys=list(keys)))

    def enable_api_key_auth_with_validator(self, validator: Callable[..., bool]) -> None:
        from gofr_tpu_torch.http.middleware.auth import apikey_auth_middleware

        self._auth_middlewares.append(apikey_auth_middleware(validator=validator,
                                                             container=self.container))

    def enable_oauth(self, jwks_url: str, refresh_interval: float = 300.0,
                     audience: str | None = None, issuer: str | None = None) -> None:
        from gofr_tpu_torch.http.middleware.auth import JWKSCache, oauth_middleware

        jwks = JWKSCache(jwks_url, refresh_interval)
        jwks.start()
        self._jwks.append(jwks)
        self._auth_middlewares.append(oauth_middleware(jwks=jwks, audience=audience, issuer=issuer))

    def enable_jwt_hs256(self, secret: bytes | str, audience: str | None = None,
                         issuer: str | None = None) -> None:
        from gofr_tpu_torch.http.middleware.auth import oauth_middleware

        secret_b = secret.encode() if isinstance(secret, str) else secret
        self._auth_middlewares.append(oauth_middleware(hs_secret=secret_b, audience=audience,
                                                       issuer=issuer))

    # -- QoS: admission control / rate limiting / load shedding ----------------

    def enable_qos(self, policy=None, **overrides: Any):
        """Turn on the QoS subsystem (also by ``QOS_ENABLED=true``): rate
        limits and load shedding at the HTTP middleware (429/503 +
        ``Retry-After``), weighted-fair priority scheduling and
        deadline-aware admission on every served engine (app.py:157-172).
        ``policy`` is a prebuilt ``QoSPolicy``; otherwise one is built from
        ``QOS_*`` config keys with ``overrides`` applied. Returns the
        AdmissionController."""
        from gofr_tpu_torch.qos import AdmissionController, QoSPolicy

        if policy is None:
            policy = QoSPolicy.from_config(self.config, **overrides)
        controller = AdmissionController(policy, self.container.metrics, logger=self.logger)
        self.container.register_qos(controller)
        return controller

    # -- other entry points (app.py:197-214) ------------------------------------

    def subscribe(self, topic: str, handler: Handler) -> None:
        if self.container.pubsub is None:
            self.logger.error(f"subscribe({topic!r}) ignored: no PUBSUB_BACKEND configured")
            return
        self._subscriptions[topic] = handler

    def add_cron_job(self, schedule: str, name: str, handler: Handler) -> None:
        self.cron.add_job(schedule, name, handler)

    def register_grpc_service(self, adder: Callable[[Any], None] | Any, servicer: Any = None) -> None:
        """Register a gRPC service: ``(add_fn, servicer)`` from generated
        code, or an ``add_fn(server)`` alone."""
        self._grpc_services.append((adder, servicer))

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
        from gofr_tpu_torch.swagger import openapi_handler, swagger_ui_handler

        router.add("GET", "/.well-known/openapi.json", openapi_handler(self))
        router.add("GET", "/.well-known/swagger", swagger_ui_handler(self))
        if self._debug_env():
            # the flight recorder's and the perf plane's read endpoints,
            # gated like the reference's pprof routes
            router.add("GET", "/debug/requests", self._debug_requests_handler)
            router.add("GET", "/debug/engine", self._debug_engine_handler)
            router.add("GET", "/debug/perf", self._debug_perf_handler)
            router.add("GET", "/debug/quality", self._debug_quality_handler)
            router.add("GET", "/debug/control", self._debug_control_handler)
            router.add("GET", "/debug/profile", self._profile_handler)
        for method, path, handler in self._routes:
            router.add(method, path, self._wrap(handler))
        for path, handler in self._ws_routes:
            router.add("GET", path, self._wrap_ws(handler))
        for route, directory in self._static:
            router.add("GET", f"{route.rstrip('/')}/{{static_tail:.*}}",
                       self._static_handler(directory))
        middlewares = [
            tracer_middleware(self.container.tracer),
            logging_middleware(self.logger),
            cors_middleware(self.config, self._registered_methods),
            metrics_middleware(self.container.metrics),
        ]
        if self.container.qos is not None:
            # after metrics (rejections show in app_http_response), before
            # auth: shed load never pays the auth path
            middlewares.append(qos_middleware(self.container.qos))
        middlewares.extend(self._auth_middlewares)
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
        auth = request.state.get(AUTH_KEY)
        if auth:
            # the verified identity (user, method, JWT claims)
            req.context().update(auth)
        qos_class = request.state.get(QOS_KEY)
        if qos_class:
            # resolved by the QoS middleware; ctx.generate picks it up
            req.context()["qos_class"] = qos_class
        return req

    def _wrap(self, handler: Handler):
        """The route handler around a user handler (app.py:443-514): async
        handlers run on the loop, sync ones on the executor, within the
        tighter of ``REQUEST_TIMEOUT`` and the client's propagated deadline;
        on a timeout the engine work the handler submitted is cancelled."""
        is_coro = inspect.iscoroutinefunction(handler)

        async def route_handler(request: ServerRequest) -> ServerResponse:
            req = self._materialize(request)
            ctx = Context(req, self.container, span=request.state.get(SPAN_KEY))
            result, err = None, None
            remaining = deadline.remaining(req.context())
            deadline_bound = False
            if remaining is not None and remaining <= 0:
                self.container.metrics.increment_counter(
                    "app_request_deadline_exceeded_total", 1, where="edge")
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
                    self.container.metrics.increment_counter(
                        "app_request_deadline_exceeded_total", 1, where="edge")
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

    def _wrap_ws(self, handler: Handler):
        """The websocket route around a user handler (app.py:518-578): the
        upgrade (a plain GET gets the 404 envelope), a server-generated
        connection id in ``ws_hub``, then the handler once per message, sync
        ones on the executor. A handler error is answered in band and the
        connection survives; a ``StreamingResponse`` goes out one frame per
        item (``encode_ws``, pulled on the executor), then ``{"done":
        true}``; an engine error mid-stream becomes an in-band error frame
        with ``done``, and a transport error cancels the generation, so the
        engine frees the slot and its pages."""
        is_coro = inspect.iscoroutinefunction(handler)

        async def ws_handler(request: ServerRequest) -> ServerResponse:
            ws = await request.upgrade_websocket()
            if ws is None:
                return await self._not_found_handler(request)
            # server-generated id: the Sec-WebSocket-Key header is client
            # controlled, and duplicates would cross-wire hub entries
            conn_id = uuid.uuid4().hex
            self.ws_hub.add(conn_id, ws)
            loop = asyncio.get_running_loop()
            try:
                async for msg in ws:
                    conn = WSConnection(conn_id, ws, msg.data, loop)
                    ctx = Context(conn, self.container)
                    try:
                        if is_coro:
                            result = await handler(ctx)
                        else:
                            result = await loop.run_in_executor(self._executor, handler, ctx)
                    except Exception as e:  # noqa: BLE001
                        self.logger.log_exception(e, "websocket handler")
                        await ws.send_str(to_json({"error": {"message": "handler error"}}).decode())
                        continue
                    if isinstance(result, StreamingResponse):
                        await self._stream_ws(ws, result)
                    elif result is not None:
                        payload = result if isinstance(result, str) else to_json(result).decode()
                        await ws.send_str(payload)
            except ConnectionError:
                pass  # the client went away; a generation it streamed is cancelled
            finally:
                self.ws_hub.remove(conn_id)
            return ServerResponse(101, content_type=None, streamed=True)

        return ws_handler

    async def _stream_ws(self, ws, stream: StreamingResponse) -> None:
        loop = asyncio.get_running_loop()
        sentinel = object()
        try:
            while True:
                item = await loop.run_in_executor(self._executor, next, stream.iterator, sentinel)
                if item is sentinel:
                    break
                await ws.send_str(stream.encode_ws(item))
            await ws.send_str(to_json({"done": True}).decode())
        except (ConnectionError, asyncio.CancelledError):
            self._cancel_stream(stream)
            raise
        except Exception as e:  # noqa: BLE001 - surface mid-stream failure in-band
            self.logger.log_exception(e, "websocket token stream")
            self._cancel_stream(stream)
            await ws.send_str(to_json({"error": {"message": str(e)}, "done": True}).decode())

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

    def _static_handler(self, directory: str):
        """Static files with the reference's hardening (app.py:594-625):
        ``openapi.json`` is never served from a static mount (403; the spec
        lives at ``/.well-known/openapi.json``), and a path that resolves
        outside the mounted directory is a 404 like any absent file."""
        import mimetypes
        import pathlib

        base = pathlib.Path(directory).resolve()

        def read(target: pathlib.Path) -> bytes:
            return target.read_bytes()

        async def handler(request: ServerRequest) -> ServerResponse:
            tail = request.path_params.get("static_tail", "")
            if pathlib.PurePosixPath(tail).name == "openapi.json":
                return _json({"error": {"message": "openapi.json is not downloadable from "
                                                   "static routes; use /.well-known/openapi.json"}},
                             403)
            try:
                target = (base / tail).resolve()
            except (OSError, ValueError):
                return await self._not_found_handler(request)
            if (base not in target.parents and target != base) or not target.is_file():
                return await self._not_found_handler(request)
            body = await asyncio.get_running_loop().run_in_executor(self._executor, read, target)
            ctype = mimetypes.guess_type(target.name)[0] or "application/octet-stream"
            return ServerResponse(200, body, content_type=ctype)

        return handler

    # -- /debug/* (APP_ENV=DEBUG; app.py:724-822) ------------------------------

    def _debug_env(self) -> bool:
        return self.config.get_or_default("APP_ENV", "").upper() == "DEBUG"

    @staticmethod
    def _debug_limit(request: ServerRequest) -> int | None:
        try:
            n = int(parse_qs(request.query_string).get("n", ["0"])[0])
        except ValueError:
            n = 0
        return n if n > 0 else None

    async def _debug_requests_handler(self, request: ServerRequest) -> ServerResponse:
        """GET /debug/requests?n=K: the last K completed request timelines
        (newest first) from the flight recorder: queue wait, TTFT, TPOT,
        e2e, slot, preemptions, trace id."""
        entries = self.container.flight.requests(limit=self._debug_limit(request))
        return _json({"data": {"count": len(entries), "requests": entries}})

    async def _debug_engine_handler(self, request: ServerRequest) -> ServerResponse:
        """GET /debug/engine?n=K: the last K device steps (kind, wall time,
        occupancy, signature, backlog, perf-plane residency, knob vector)
        and a health snapshot of every served engine with its KV layout and
        dtype, its adapter plane, and a role worker's handoff counters."""
        steps = self.container.flight.steps(limit=self._debug_limit(request))
        engines = {}
        for name, engine in self.container.engines.items():
            snap = dict(engine.health_check() if hasattr(engine, "health_check") else {})
            layout = getattr(engine, "kv_layout", None)
            if layout is not None:
                snap["kv"] = {"layout": layout,
                              "dtype": getattr(engine, "kv_quantize", "") or "bf16"}
            ad_stats = getattr(engine, "adapter_stats", None)
            if callable(ad_stats):
                snap["adapters"] = ad_stats()
            handoff = _handoff_snapshot(engine)
            if handoff:
                snap["handoff"] = handoff
            report = getattr(engine, "autotune_report", None)
            rep = report() if callable(report) else None
            if rep:
                snap["autotune"] = rep
            engines[name] = snap
        return _json({"data": {"count": len(steps), "steps": steps, "engines": engines}})

    async def _debug_perf_handler(self, _request: ServerRequest) -> ServerResponse:
        """GET /debug/perf: per engine the perf plane's windowed MFU/MBU by
        step kind, the pipeline bubble ratio, the page pool's waste and a
        role worker's handoff transfer plane (mode, streams, bytes and
        seconds a stream, overlap ratio; app.py:805-813); and the
        container's exact rollup with its derived ratios."""
        now = time.monotonic()
        engines = {}
        for name, engine in self.container.engines.items():
            plane = getattr(engine, "perf", None)
            if plane is None:
                continue
            snap = plane.snapshot(now)
            stats_fn = getattr(engine, "page_pool_stats", None)
            stats = stats_fn() if callable(stats_fn) else None
            if stats:
                snap["page_pool"] = stats
            report = getattr(engine, "autotune_report", None)
            rep = report() if callable(report) else None
            if rep and rep.get("decisions"):
                # every pinned op is a decode attention kernel, so each pin
                # joins the roofline of the step kinds it runs in
                kinds = snap.get("kinds", {})
                snap["autotune"] = {
                    op: {"pin": rec, "roofline": {k: kinds[k] for k in ("decode", "spec")
                                                  if k in kinds} or None}
                    for op, rec in rep["decisions"].items()}
            handoff = _handoff_snapshot(engine)
            if handoff:
                snap["handoff"] = handoff
            engines[name] = snap
        totals = self.container.perf_totals()
        rollup = None if totals is None else {"totals": totals, **perf_mod.derive(totals)}
        return _json({"data": {"engines": engines, "rollup": rollup}})

    async def _debug_control_handler(self, request: ServerRequest) -> ServerResponse:
        """GET /debug/control?n=K (app.py:823-845): per engine the step
        controller's live state (each knob's value, allowed range and frozen
        flag, this engine's pins, the gate, the trial in progress, the last
        judged evidence and its decisions; an engine without a controller
        reports ``{"enabled": false}`` and its knob vector), and the flight
        recorder's last K decisions."""
        engines = {}
        for name, engine in self.container.engines.items():
            report = getattr(engine, "control_report", None)
            if callable(report):
                engines[name] = report()
        decisions = self.container.flight.controls(limit=self._debug_limit(request))
        return _json({"data": {"engines": engines, "decisions": decisions}})

    async def _debug_quality_handler(self, _request: ServerRequest) -> ServerResponse:
        """GET /debug/quality (app.py:843-880): per engine the quality
        plane's totals and recent divergence reports (replay payloads
        trimmed; the capture bundles carry them) and the speculative
        accept totals by adapter; and each class's quality SLO windows."""
        engines = {}
        for name, engine in self.container.engines.items():
            entry: dict = {}
            snap_fn = getattr(engine, "quality_snapshot", None)
            snap = snap_fn() if callable(snap_fn) else None
            if snap is not None:
                snap = dict(snap)
                snap["recent"] = [{k: v for k, v in e.items() if k not in ("prompt", "emitted")}
                                  for e in snap.get("recent", [])]
                entry["shadow"] = snap
            totals_fn = getattr(engine, "spec_accept_totals", None)
            totals = totals_fn() if callable(totals_fn) else None
            if totals:
                entry["spec_accept"] = {
                    adapter: {"accepted": acc, "proposed": prop,
                              "ratio": round(acc / prop, 4) if prop else None}
                    for adapter, (acc, prop) in totals.items()}
            if entry:
                engines[name] = entry
        slo = self.container.slo
        objectives = None
        if slo is not None:
            objectives = {cls: {"quality": objs["quality"]}
                          for cls, objs in slo.snapshot().items() if "quality" in objs}
        return _json({"data": {"engines": engines, "slo": objectives}})

    async def _profile_handler(self, request: ServerRequest) -> ServerResponse:
        """GET /debug/profile?seconds=N (app.py:681-722): record N seconds
        of the process with ``torch.profiler`` (``metrics.slo.
        record_trace``: CUDA activity on the card, every kernel launched
        from any thread) and write a Chrome trace to a new directory under
        ``PROFILER_DIR``, which the reply names. N is 2 by default; a
        non-finite N or one outside (0, 300] is a 400, others clamp to
        [0.1, 60]; a second capture while one runs is a 409."""
        try:
            seconds = float(parse_qs(request.query_string).get("seconds", ["2"])[0])
            if not math.isfinite(seconds):
                raise ValueError(seconds)
        except ValueError:
            return _json({"error": {"message": "seconds must be a finite number"}}, 400)
        if seconds <= 0 or seconds > 300.0:
            return _json({"error": {"message": "seconds must be in (0, 300]"}}, 400)
        seconds = min(max(seconds, 0.1), 60.0)
        if not self._profile_busy.acquire(blocking=False):
            return _json({"error": {"message": "a profile capture is already running"}}, 409)
        out_root = self.config.get_or_default("PROFILER_DIR", "/tmp/gofr_tpu_profile")
        path = os.path.join(out_root, time.strftime("trace-%Y%m%d-%H%M%S"))
        try:
            await asyncio.get_running_loop().run_in_executor(
                self._executor, record_trace, path, seconds)
        except Exception as e:  # noqa: BLE001
            return _json({"error": {"message": str(e)}}, 500)
        finally:
            self._profile_busy.release()
        return _json({"data": {"trace_dir": path, "seconds": seconds}})

    # -- subscription manager (gofr subscriber.go; app.py:889-945) -------------

    def _start_subscribers(self) -> None:
        # SUBSCRIBER_WORKERS > 1 runs N consumer threads a topic: with a
        # model engine in the handler, N messages in flight can share one
        # device batch instead of queueing one behind another
        workers = max(1, self.config.get_int("SUBSCRIBER_WORKERS", 1))
        for topic, handler in self._subscriptions.items():
            for w in range(workers):
                t = threading.Thread(target=self._subscribe_loop, args=(topic, handler),
                                     name=f"gofr-sub-{topic}-{w}", daemon=True)
                t.start()
                self._sub_threads.append(t)

    def _subscribe_loop(self, topic: str, handler: Handler) -> None:
        container = self.container
        group = self.config.get_or_default("CONSUMER_GROUP", container.app_name)
        while not self._sub_stop.is_set():
            try:
                msg = container.pubsub.subscribe(topic, group=group, timeout=0.5)
            except Exception as e:  # noqa: BLE001
                container.logger.errorf("subscribe %s failed: %r", topic, e)
                self._sub_stop.wait(1.0)
                continue
            if msg is None:
                continue
            container.metrics.increment_counter("app_pubsub_subscribe_total_count", 1, topic=topic)
            # join the publisher's trace when the message carries one
            span = container.tracer.start_span(
                f"subscribe {topic}", kind="CONSUMER", set_current=False,
                traceparent=msg.param("traceparent") or None)
            ctx = Context(msg, container, span=span)
            try:
                result = handler(ctx)
                if inspect.iscoroutine(result):
                    result.close()
                    raise TypeError("subscribe handlers must be synchronous (they run on a "
                                    "consumer thread)")
                msg.commit()  # at-least-once: commit only on success (subscriber.go:54-56)
                container.metrics.increment_counter("app_pubsub_subscribe_success_count", 1,
                                                    topic=topic)
                span.set_status("OK")
            except Exception as e:  # noqa: BLE001
                span.set_status("ERROR")
                container.logger.errorf("subscriber for %s failed: %r", topic, e)
            finally:
                span.finish()

    def _stop_entry_points(self, grpc_server) -> None:
        """Stop what ``arun`` started beside the HTTP servers and join its
        threads: the consumers, the cron table, the gRPC server and the JWKS
        pollers."""
        self._sub_stop.set()
        for t in self._sub_threads:
            t.join(timeout=5.0)
        self._sub_threads = []
        self.cron.stop()
        if grpc_server is not None:
            grpc_server.stop(grace=2).wait(5.0)
            grpc_server.gofr_pool.shutdown(wait=True)
        for jwks in self._jwks:
            jwks.stop()

    # -- run -------------------------------------------------------------------

    def run(self) -> None:
        """Start every configured server; blocks until SIGINT/SIGTERM."""
        try:
            asyncio.run(self.arun())
        except KeyboardInterrupt:
            pass

    async def _warm_engines(self) -> None:
        """``ENGINE_WARMUP=true`` (app.py:965-993): warm each engine whose
        ``warmup`` needs no example input, before the servers start, and
        log its count. A warmup that fails is logged with its traceback and
        the engine still serves; no kernel has a fallback, so a first
        request that meets the same fault fails loudly too."""
        if self.config.get_or_default("ENGINE_WARMUP", "false").lower() != "true":
            return
        loop = asyncio.get_running_loop()
        for name, engine in self.container.engines.items():
            if not hasattr(engine, "warmup"):
                continue
            try:
                needs_example = any(
                    p.default is p.empty
                    and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                    for p in inspect.signature(engine.warmup).parameters.values())
            except (TypeError, ValueError):
                needs_example = True
            if needs_example:
                continue
            try:
                n = await loop.run_in_executor(self._executor, engine.warmup)
                self.logger.infof("model engine %s warmed (%d programs)", name, n)
            except Exception as e:  # noqa: BLE001 - logged; the engine still serves
                self.logger.log_exception(e, f"engine {name} warmup failed")

    async def arun(self, ready: asyncio.Event | None = None) -> None:
        """Serve until ``stop()``: the engines warmed first under
        ``ENGINE_WARMUP``, then the metrics server on ``METRICS_PORT``,
        the HTTP server on ``HTTP_PORT`` when a route, a websocket route or
        a static mount is registered or ``APP_ENV=DEBUG`` serves the debug
        routes, the gRPC server on ``GRPC_PORT`` when a service is
        registered, the subscribers and the cron table; then ``ready`` is
        set. A server that cannot bind raises. On the way out the
        consumers, cron, gRPC and the JWKS pollers stop and their threads
        are joined, the servers close, the container stops the engines and
        the broker, and the executor shuts down."""
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, self._shutdown.set)
            except (NotImplementedError, RuntimeError, ValueError):
                pass
        grpc_server = None
        try:
            await self._warm_engines()
            metrics = self._build_metrics_server()
            await metrics.start(port=self.metrics_port)
            self._servers.append(metrics)
            self.metrics_port = metrics.port
            self.logger.infof("metrics server on :%d/metrics", self.metrics_port)
            if self._routes or self._ws_routes or self._static or self._debug_env():
                http = self._build_http_server()
                await http.start(port=self.http_port)
                self._servers.append(http)
                self.http_port = http.port
                self.logger.infof("HTTP server on :%d", self.http_port)
            if self._grpc_services:
                from gofr_tpu_torch.grpc.server import start_grpc_server

                grpc_server = start_grpc_server(self)
                self.logger.infof("gRPC server on :%d", self.grpc_port)
            self._start_subscribers()
            self.cron.start()
            if ready is not None:
                ready.set()
            await self._shutdown.wait()
            self.logger.info("shutting down")
        finally:
            self._stop_entry_points(grpc_server)
            for server in self._servers:
                await server.close()
            self._servers = []
            self.container.close()
            self._executor.shutdown(wait=False, cancel_futures=True)

    def stop(self) -> None:
        self._shutdown.set()


def _handoff_snapshot(engine) -> dict | None:
    """A role worker's handoff counters (``GenerateEngine.handoff_stats``),
    or None for a colocated engine."""
    stats_fn = getattr(engine, "handoff_stats", None)
    stats = stats_fn() if callable(stats_fn) else None
    return stats if stats and ("export" in stats or "import" in stats) else None


def new_testing(config: dict[str, str] | None = None) -> App:
    """App wired to a mock container for tests."""
    return App(config=DictConfig(config or {}), container=new_mock_container(config))
