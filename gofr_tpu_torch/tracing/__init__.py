"""Tracing: W3C-traceparent distributed tracing with pluggable span
exporters (the port's own copy of gofr_tpu/tracing/__init__.py; the span,
exporter and config names are the JAX package's, so a collector, a
dashboard or a config written for it reads the port's the same way).

Capability parity with the reference's tracing (gofr `pkg/gofr/gofr.go:307-422`,
`pkg/gofr/exporter.go`): a tracer initialized from config (``TRACE_EXPORTER``
= none|console|zipkin|otlp|memory; ``TRACER_URL``, ``TRACER_HOST``,
``TRACER_PORT``), per-request server spans with traceparent extraction, child
spans per user ``ctx.trace(name)``, and background-batched HTTP span exporters
— Zipkin JSON v2 and OTLP/HTTP JSON for OpenTelemetry collectors, POSTed with
``urllib``.

Spans are plain objects + contextvars, so tracing adds no hot-path
dependency. The engine reuses the same spans to stitch its request timeline:
``RequestTrace`` carries the inbound server span across the submit-thread →
device-loop boundary (contextvars don't cross threads) and hangs
``engine.queue_wait``/``engine.prefill``/``engine.decode``/``engine.finish``
children under it, guarded by ``Tracer.enabled`` so ``TRACE_EXPORTER=none``
costs the serving loop one branch. The exporter thread of a zipkin or otlp
tracer ends in ``Tracer.shutdown`` (``Container.close``).
"""

from __future__ import annotations

import contextvars
import json
import os
import queue
import threading
import time
import urllib.request
from typing import Any, Iterator
from contextlib import contextmanager

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "gofr_tpu_torch_current_span", default=None
)


def _rand_hex(nbytes: int) -> str:
    # os.urandom: fork-safe and never seed-correlated — the global `random`
    # module would hand every pre-forked worker (and every process sharing a
    # seeded RNG) colliding trace/span ids
    return os.urandom(nbytes).hex()


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start", "end",
        "attributes", "status", "kind", "sampled", "events", "_tracer", "_token",
    )

    def __init__(self, name: str, trace_id: str, span_id: str, parent_id: str | None,
                 tracer: "Tracer | None", kind: str = "INTERNAL", sampled: bool = True):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        self.start = time.time()
        self.end: float | None = None
        self.attributes: dict[str, Any] = {}
        self.status: str = "OK"
        self.kind = kind
        self.events: list[dict[str, Any]] | None = None  # lazily allocated
        self._tracer = tracer
        self._token: contextvars.Token | None = None

    def set_attribute(self, key: str, value: Any) -> "Span":
        self.attributes[key] = value
        return self

    def add_event(self, name: str, **attributes: Any) -> "Span":
        """Attach a timestamped point event (e.g. one chunked-prefill chunk)
        — cheaper than a child span for things with no meaningful duration."""
        if self.events is None:
            self.events = []
        self.events.append({"name": name, "ts": time.time(), "attributes": attributes})
        return self

    def set_status(self, status: str) -> "Span":
        self.status = status
        return self

    def finish(self) -> None:
        if self.end is not None:
            return
        self.end = time.time()
        if self._token is not None:
            try:
                _current_span.reset(self._token)
            except ValueError:
                _current_span.set(None)
            self._token = None
        if self._tracer is not None:
            self._tracer._on_finish(self)

    # context-manager sugar
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.status = "ERROR"
            self.attributes.setdefault("error", repr(exc))
        self.finish()

    @property
    def duration_us(self) -> int:
        end = self.end if self.end is not None else time.time()
        return int((end - self.start) * 1e6)

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"


class SpanExporter:
    def export(self, spans: list[Span]) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class NoopExporter(SpanExporter):
    def export(self, spans: list[Span]) -> None:
        pass


class ConsoleExporter(SpanExporter):
    def __init__(self, logger):
        self._logger = logger

    def export(self, spans: list[Span]) -> None:
        for s in spans:
            self._logger.debug({
                "span": s.name, "trace_id": s.trace_id, "span_id": s.span_id,
                "parent_id": s.parent_id, "duration_us": s.duration_us,
                "status": s.status, **{f"attr.{k}": v for k, v in s.attributes.items()},
            })


class MemoryExporter(SpanExporter):
    """Collects finished spans for test assertions."""

    def __init__(self):
        self.spans: list[Span] = []
        self._lock = threading.Lock()

    def export(self, spans: list[Span]) -> None:
        with self._lock:
            self.spans.extend(spans)

    def by_name(self, name: str) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name]


class ZipkinExporter(SpanExporter):
    """POSTs Zipkin v2 JSON batches (the wire format the reference's hosted
    exporter also produces)."""

    def __init__(self, endpoint: str, service_name: str, timeout: float = 5.0):
        self.endpoint = endpoint
        self.service_name = service_name
        self.timeout = timeout

    def export(self, spans: list[Span]) -> None:
        payload = [self._to_zipkin(s) for s in spans]
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            self.endpoint, data=body, headers={"Content-Type": "application/json"}, method="POST"
        )
        try:
            urllib.request.urlopen(req, timeout=self.timeout).close()
        except Exception:  # noqa: BLE001 - tracing must never break serving
            pass

    def _to_zipkin(self, s: Span) -> dict[str, Any]:
        out = {
            "id": s.span_id,
            "traceId": s.trace_id,
            "name": s.name,
            "timestamp": int(s.start * 1e6),
            "duration": s.duration_us,
            "localEndpoint": {"serviceName": self.service_name},
            "tags": {str(k): str(v) for k, v in s.attributes.items()},
        }
        # absent fields are OMITTED, not null: strict Zipkin collectors
        # reject literal `"kind": null` / `"parentId": null` payloads
        if s.parent_id:
            out["parentId"] = s.parent_id
        if s.kind in ("SERVER", "CLIENT", "PRODUCER", "CONSUMER"):
            out["kind"] = s.kind
        if s.events:
            out["annotations"] = [
                {"timestamp": int(e["ts"] * 1e6), "value": e["name"]} for e in s.events
            ]
        return out


# OTLP SpanKind enum (trace.proto): engine/user spans are INTERNAL
_OTLP_KIND = {"INTERNAL": 1, "SERVER": 2, "CLIENT": 3, "PRODUCER": 4, "CONSUMER": 5}


def _otlp_value(v: Any) -> dict[str, Any]:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # proto3 JSON: int64 as string
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _otlp_attrs(attrs: dict[str, Any]) -> list[dict[str, Any]]:
    return [{"key": str(k), "value": _otlp_value(v)} for k, v in attrs.items()]


class OTLPExporter(SpanExporter):
    """OTLP/HTTP JSON exporter: POSTs an ``ExportTraceServiceRequest`` to a
    collector's ``/v1/traces`` endpoint (proto3 JSON mapping of
    opentelemetry/proto/trace/v1 — the wire format every OTel collector
    accepts on :4318). Closes the documented ``TRACE_EXPORTER=otlp`` gap."""

    def __init__(self, endpoint: str, service_name: str, timeout: float = 5.0):
        self.endpoint = endpoint
        self.service_name = service_name
        self.timeout = timeout

    def export(self, spans: list[Span]) -> None:
        body = json.dumps(self.to_payload(spans)).encode()
        req = urllib.request.Request(
            self.endpoint, data=body, headers={"Content-Type": "application/json"}, method="POST"
        )
        try:
            urllib.request.urlopen(req, timeout=self.timeout).close()
        except Exception:  # noqa: BLE001 - tracing must never break serving
            pass

    def to_payload(self, spans: list[Span]) -> dict[str, Any]:
        return {
            "resourceSpans": [{
                "resource": {"attributes": _otlp_attrs({"service.name": self.service_name})},
                "scopeSpans": [{
                    # the JAX package's scope name: collectors key on it
                    "scope": {"name": "gofr_tpu"},
                    "spans": [self._to_otlp(s) for s in spans],
                }],
            }]
        }

    def _to_otlp(self, s: Span) -> dict[str, Any]:
        out = {
            "traceId": s.trace_id,
            "spanId": s.span_id,
            "name": s.name,
            "kind": _OTLP_KIND.get(s.kind, 1),
            "startTimeUnixNano": str(int(s.start * 1e9)),
            "endTimeUnixNano": str(int((s.end if s.end is not None else time.time()) * 1e9)),
            "attributes": _otlp_attrs(s.attributes),
            # STATUS_CODE_ERROR=2; finished-OK spans report UNSET (0), the
            # OTel default for spans nobody explicitly marked
            "status": {"code": 2, "message": "error"} if s.status == "ERROR" else {},
        }
        if s.parent_id:
            out["parentSpanId"] = s.parent_id
        if s.events:
            out["events"] = [
                {"timeUnixNano": str(int(e["ts"] * 1e9)), "name": e["name"],
                 "attributes": _otlp_attrs(e["attributes"])}
                for e in s.events
            ]
        return out


class Tracer:
    """Process tracer with background batch export."""

    def __init__(self, exporter: SpanExporter | None = None,
                 batch_size: int = 64, flush_interval: float = 2.0):
        self._exporter = exporter or NoopExporter()
        self._queue: queue.SimpleQueue[Span | None] = queue.SimpleQueue()
        self._batch_size = batch_size
        self._flush_interval = flush_interval
        self._worker: threading.Thread | None = None
        self._closed = False
        if not isinstance(self._exporter, (NoopExporter, MemoryExporter, ConsoleExporter)):
            self._worker = threading.Thread(target=self._run, name="gofr-span-export", daemon=True)
            self._worker.start()

    @property
    def enabled(self) -> bool:
        """False when spans go nowhere (``TRACE_EXPORTER=none``) — the hot
        path's guard: callers skip span construction entirely, so disabled
        tracing costs one attribute read and an isinstance check."""
        return not isinstance(self._exporter, NoopExporter)

    def start_span(self, name: str, parent: Span | None = None,
                   traceparent: str | None = None, kind: str = "INTERNAL",
                   set_current: bool = True) -> Span:
        if parent is None:
            parent = _current_span.get()
        trace_id: str | None = None
        parent_id: str | None = None
        sampled = True
        if parent is not None:
            trace_id, parent_id, sampled = parent.trace_id, parent.span_id, parent.sampled
        elif traceparent:
            parsed = parse_traceparent(traceparent)
            if parsed:
                trace_id, parent_id, sampled = parsed
        if trace_id is None:
            trace_id = _rand_hex(16)
        span = Span(name, trace_id, _rand_hex(8), parent_id, self, kind=kind, sampled=sampled)
        if set_current:
            span._token = _current_span.set(span)
        return span

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        s = self.start_span(name)
        s.attributes.update(attrs)
        try:
            yield s
        except Exception as exc:
            s.status = "ERROR"
            s.attributes.setdefault("error", repr(exc))
            raise
        finally:
            s.finish()

    def _on_finish(self, span: Span) -> None:
        if isinstance(self._exporter, (MemoryExporter, ConsoleExporter)):
            self._exporter.export([span])
        elif self._worker is not None and not self._closed:
            self._queue.put(span)

    def _run(self) -> None:
        batch: list[Span] = []
        deadline = time.monotonic() + self._flush_interval
        while True:
            timeout = max(0.01, deadline - time.monotonic())
            try:
                item = self._queue.get(timeout=timeout)
                if item is None:
                    break
                batch.append(item)
            except Exception:  # noqa: BLE001 - queue.Empty
                pass
            if batch and (len(batch) >= self._batch_size or time.monotonic() >= deadline):
                self._safe_export(batch)
                batch = []
                deadline = time.monotonic() + self._flush_interval
            elif time.monotonic() >= deadline:
                deadline = time.monotonic() + self._flush_interval
        if batch:
            self._safe_export(batch)

    def _safe_export(self, batch: list[Span]) -> None:
        # a faulty exporter must not kill the export thread (spans would then
        # accumulate unbounded in the queue with no consumer)
        try:
            self._exporter.export(batch)
        except Exception:  # noqa: BLE001
            pass

    def shutdown(self) -> None:
        self._closed = True
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join(timeout=5)
        self._exporter.shutdown()


def current_span() -> Span | None:
    return _current_span.get()


class RequestTrace:
    """Per-request engine span bundle, carried across the submit-thread →
    device-loop boundary on the request's kw context.

    contextvars do NOT cross threads — the HTTP/gRPC/pubsub server span is
    therefore propagated *explicitly* as ``parent`` and every engine child
    (``engine.queue_wait`` → ``engine.prefill`` → ``engine.decode`` →
    ``engine.finish``) starts with ``set_current=False``, so the device
    thread's contextvar state is never touched. Without an inbound parent a
    synthetic ``engine.request`` root is opened so direct ``engine.generate``
    callers still get a stitched timeline. Construct only behind
    ``Tracer.enabled`` — this object existing *is* the per-request cost."""

    __slots__ = ("tracer", "parent", "trace_id", "spans", "_root")

    def __init__(self, tracer: "Tracer", parent: Span | None = None):
        self.tracer = tracer
        if parent is None:
            parent = tracer.start_span("engine.request", set_current=False)
            self._root: Span | None = parent
        else:
            self._root = None
        self.parent = parent
        self.trace_id = parent.trace_id
        self.spans: dict[str, Span] = {}

    def begin(self, name: str, **attrs: Any) -> Span:
        span = self.tracer.start_span(name, parent=self.parent, set_current=False)
        if attrs:
            span.attributes.update(attrs)
        self.spans[name] = span
        return span

    def end(self, name: str, **attrs: Any) -> None:
        """Finish the named phase span; no-op when it was never begun or
        already ended (re-admission after preemption re-begins phases)."""
        span = self.spans.pop(name, None)
        if span is not None:
            if attrs:
                span.attributes.update(attrs)
            span.finish()

    def event(self, within: str, name: str, **attrs: Any) -> None:
        span = self.spans.get(within)
        if span is not None:
            span.add_event(name, **attrs)

    def close_all(self, error: Exception | None = None) -> None:
        """Finish every still-open span (and the synthetic root) — the
        request's done callback calls this so cancelled/timed-out/failed
        requests never leak open spans."""
        spans, self.spans = self.spans, {}
        for span in spans.values():
            if error is not None:
                span.status = "ERROR"
                span.attributes.setdefault("error", repr(error))
            span.finish()
        if self._root is not None:
            if error is not None:
                self._root.status = "ERROR"
            self._root.finish()


def parse_traceparent(header: str) -> tuple[str, str, bool] | None:
    """Parse a W3C traceparent ``00-<32hex traceid>-<16hex spanid>-<flags>``.

    Returns ``(trace_id, parent_span_id, sampled)`` — the sampled flag is
    preserved so an unsampled upstream trace is not upgraded on propagation.
    """
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, flags = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
        sampled = bool(int(flags, 16) & 0x01) if flags else True
    except ValueError:
        return None
    return trace_id, span_id, sampled


def tracer_from_config(config, logger, service_name: str) -> Tracer:
    """Exporter selected by TRACE_EXPORTER config (gofr `gofr.go:365-380`)."""
    exporter_name = (config.get("TRACE_EXPORTER") or "none").lower()
    if exporter_name in ("", "none"):
        return Tracer(NoopExporter())
    if exporter_name == "console":
        return Tracer(ConsoleExporter(logger))
    if exporter_name == "memory":
        # in-process collection for tests/debugging: assert on
        # container.tracer._exporter.spans with no network in the loop
        return Tracer(MemoryExporter())
    if exporter_name == "otlp":
        url = config.get("TRACER_URL") or config.get("TRACER_HOST")
        if not url:
            logger.warn("TRACE_EXPORTER=otlp but TRACER_URL missing; tracing disabled")
            return Tracer(NoopExporter())
        if not url.startswith("http"):
            port = config.get_or_default("TRACER_PORT", "4318") if hasattr(config, "get_or_default") else "4318"
            url = f"http://{url}:{port}"
        if "/v1/traces" not in url:
            url = url.rstrip("/") + "/v1/traces"
        return Tracer(OTLPExporter(url, service_name))
    if exporter_name in ("zipkin", "gofr"):
        url = config.get("TRACER_URL") or config.get("TRACER_HOST")
        if not url:
            logger.warn("TRACE_EXPORTER set but TRACER_URL missing; tracing disabled")
            return Tracer(NoopExporter())
        if not url.startswith("http"):
            port = config.get_or_default("TRACER_PORT", "9411") if hasattr(config, "get_or_default") else "9411"
            url = f"http://{url}:{port}/api/v2/spans"
        return Tracer(ZipkinExporter(url, service_name))
    logger.warnf("unknown TRACE_EXPORTER %r; tracing disabled", exporter_name)
    return Tracer(NoopExporter())
