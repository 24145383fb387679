"""The port's tracing (gofr_tpu_torch.tracing, the tracer middleware and the
engine's span timeline) held against the JAX package's (gofr_tpu/tracing,
gofr_tpu/tpu/engine.py:488-515 and the span sites of its admission and
folds).

Tolerances: exact. ``traceparent`` parsing and the Zipkin / OTLP payloads
of the same spans with fixed ids and times are equal to JAX's. For the same
traffic on ``LlamaConfig.tiny()`` (the JAX weights, ``params_from_jax``)
each request's engine spans — names in the order they began, their parent
(the request's server span), their attribute keys and event names — equal
the JAX engine's, on the bf16 pool (plain and chunked prefill, a prefix
hit, forced preemption) and the slot cache. Traffic is submitted while the
loop is held at its state lock, so both engines drain the same burst at
once.
"""

import http.server
import json
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

PAGE = 8
BUCKETS = [8, 16]
N_NEW = 10
PREFIX = [(7 * i + 3) % 256 for i in range(2 * PAGE)]
# prefix hits on the chunked path (past the 16 bucket) and on the batched
# path's hit route (a page of 12 tokens), prompts that chunk, prompts that
# batch
BURST = [PREFIX + [11, 12, 13, 14], PREFIX + list(range(40, 61)), PREFIX[:PAGE] + [21, 22, 23, 24],
         [5] * 9, list(range(90, 103)), [200, 17, 33], list(range(120, 138)), [1, 2], [9, 8, 7],
         list(range(60, 90))]
WARM = PREFIX + [1, 2, 3]


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(7))
    model = params_from_jax(PortConfig.tiny(), jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, model


def engines(tiny, **kw):
    """(JAX engine, port engine), each on a mock container whose tracer
    collects spans in memory."""
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu.tracing import MemoryExporter as JaxMemory
    from gofr_tpu.tracing import Tracer as JaxTracer
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import GenerateEngine
    from gofr_tpu_torch.tracing import MemoryExporter, Tracer

    jcfg, params, model = tiny
    kw = {"slots": 4, "max_len": 64, "max_prefill_batch": 2, **kw}
    jc = jax_container()
    jc.tracer = JaxTracer(JaxMemory())
    pc = new_mock_container()
    pc.tracer = Tracer(MemoryExporter())
    return (JaxEngine(llama, jcfg, params, jc, decode_pipeline=2, **kw),
            GenerateEngine(model, device="cpu", container=pc, **kw))


def serve(eng, warm, burst, n_new=N_NEW, **submit_kw):
    """``warm`` alone, then ``burst`` submitted while the loop waits at its
    state lock (so one admission round sees all of it), each under its own
    server span. Returns (results, server spans) in ``[warm] + burst``
    order."""
    tracer = eng.container.tracer
    servers = [tracer.start_span(f"POST /{i}", kind="SERVER", set_current=False)
               for i in range(1 + len(burst))]
    out = [eng.generate(warm, max_new_tokens=n_new, timeout=300, _parent_span=servers[0],
                        **submit_kw)]
    settle(eng)
    with eng._state_lock:
        reqs = [eng.submit(p, max_new_tokens=n_new, _parent_span=s, **submit_kw)
                for p, s in zip(burst, servers[1:])]
    out += [r.result(timeout=300) for r in reqs]
    for s in servers:
        s.finish()
    return out, servers


def settle(eng) -> None:
    """Wait until the in-flight queue stays empty: a finished lane's chunk
    can still be in flight after its result, and the burst must find both
    engines in the same state."""
    quiet, deadline = 0, time.monotonic() + 60
    while quiet < 3 and time.monotonic() < deadline:
        quiet = 0 if eng._dq else quiet + 1
        time.sleep(0.02)


def timeline(spans, server) -> list:
    """The engine spans of one request: (name, attribute keys, event
    names) in the order they began; each must hang under ``server``."""
    mine = [s for s in spans if s.trace_id == server.trace_id and s is not server
            and s.span_id != server.span_id]
    for s in mine:
        assert s.parent_id == server.span_id, (s.name, s.parent_id, server.span_id)
        assert s.end is not None, f"{s.name} left open"
    mine.sort(key=lambda s: s.start)
    return [(s.name, sorted(s.attributes), [e["name"] for e in s.events or []]) for s in mine]


# -- the tracer alone ----------------------------------------------------------------


TRACEPARENTS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00",
    " 00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01 ",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "00-zzf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-zz",
    "garbage",
    "",
]


@pytest.mark.quick
@pytest.mark.parametrize("header", TRACEPARENTS)
def test_traceparent_parses_as_the_jax_tracer(header):
    """``parse_traceparent`` gives JAX's (trace id, parent id, sampled) or
    None; a span started from a valid header carries the trace and the
    sampled flag on, and its own ``traceparent()`` parses back to it."""
    from gofr_tpu.tracing import parse_traceparent as jax_parse
    from gofr_tpu_torch.tracing import MemoryExporter, Tracer, parse_traceparent

    assert parse_traceparent(header) == jax_parse(header)
    span = Tracer(MemoryExporter()).start_span("s", traceparent=header, set_current=False)
    parsed = jax_parse(header)
    if parsed:
        assert (span.trace_id, span.parent_id, span.sampled) == parsed
    assert parse_traceparent(span.traceparent()) == (span.trace_id, span.span_id, span.sampled)


def _spans(mod):
    """The same three finished spans in either package: a SERVER root with
    an int, a float, a bool and a string attribute, an INTERNAL child with
    two events, and an ERROR child; ids and times fixed."""
    t = mod.Tracer(mod.MemoryExporter())
    root = mod.Span("POST /generate", "ab" * 16, "01" * 8, None, t, kind="SERVER")
    child = mod.Span("engine.prefill", "ab" * 16, "02" * 8, root.span_id, t)
    err = mod.Span("engine.decode", "ab" * 16, "03" * 8, root.span_id, t, sampled=False)
    for i, s in enumerate((root, child, err)):
        s.start = 1_700_000_000.0 + i * 0.25
    root.attributes.update({"http.status_code": 201, "w": 0.5, "ok": True, "who": "x"})
    child.events = [{"name": "chunk", "ts": 1_700_000_000.3, "attributes": {"offset": 16}},
                    {"name": "swapin", "ts": 1_700_000_000.4, "attributes": {"pages": 2}}]
    err.status = "ERROR"
    for i, s in enumerate((root, child, err)):
        s.end = 1_700_000_001.0 + i * 0.125
    return [root, child, err]


@pytest.mark.quick
def test_zipkin_and_otlp_payloads_equal_jax_s():
    """Zipkin v2 JSON (one record a span) and the OTLP/HTTP JSON request of
    the same spans are equal to the JAX exporters' byte for byte."""
    import gofr_tpu.tracing as jt
    import gofr_tpu_torch.tracing as pt

    got, want = _spans(pt), _spans(jt)
    pz, jz = pt.ZipkinExporter("http://x", "svc"), jt.ZipkinExporter("http://x", "svc")
    assert [pz._to_zipkin(s) for s in got] == [jz._to_zipkin(s) for s in want]
    po, jo = pt.OTLPExporter("http://x", "svc"), jt.OTLPExporter("http://x", "svc")
    assert json.dumps(po.to_payload(got)) == json.dumps(jo.to_payload(want))


CONFIGS = [
    {}, {"TRACE_EXPORTER": "none"}, {"TRACE_EXPORTER": "console"}, {"TRACE_EXPORTER": "memory"},
    {"TRACE_EXPORTER": "zipkin"}, {"TRACE_EXPORTER": "otlp"}, {"TRACE_EXPORTER": "bogus"},
    {"TRACE_EXPORTER": "zipkin", "TRACER_URL": "http://127.0.0.1:9/api/v2/spans"},
    {"TRACE_EXPORTER": "gofr", "TRACER_HOST": "localhost", "TRACER_PORT": "9412"},
    {"TRACE_EXPORTER": "otlp", "TRACER_URL": "http://127.0.0.1:9"},
    {"TRACE_EXPORTER": "otlp", "TRACER_HOST": "localhost"},
]


@pytest.mark.parametrize("conf", CONFIGS, ids=lambda c: "-".join(c.values()) or "unset")
def test_tracer_from_config_picks_jax_s_exporter(conf):
    """``tracer_from_config`` picks the JAX exporter class and endpoint for
    every ``TRACE_EXPORTER`` / ``TRACER_*`` combination."""
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu.logging import MockLogger as JaxLogger
    from gofr_tpu.tracing import tracer_from_config as jax_from_config
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.logging import MockLogger
    from gofr_tpu_torch.tracing import tracer_from_config

    got = tracer_from_config(DictConfig(conf), MockLogger(), "svc")
    want = jax_from_config(JaxConfig(conf), JaxLogger(), "svc")
    try:
        assert type(got._exporter).__name__ == type(want._exporter).__name__
        assert getattr(got._exporter, "endpoint", None) == getattr(want._exporter, "endpoint", None)
        assert got.enabled == want.enabled
    finally:
        got.shutdown()
        want.shutdown()


class _Sink:
    """A stdlib HTTP sink on localhost collecting POSTed JSON bodies."""

    def __init__(self):
        self.bodies = []
        sink = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                sink.bodies.append((self.path, json.loads(self.rfile.read(n))))
                self.send_response(202)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.server = http.server.HTTPServer(("127.0.0.1", 0), H)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("exporter", ["zipkin", "otlp"])
def test_batched_exporter_posts_and_its_thread_ends_on_shutdown(exporter):
    """A zipkin / otlp tracer batches spans on its exporter thread and
    POSTs them to the configured sink; ``shutdown`` flushes the batch and
    the thread ends (``Container.close`` calls it)."""
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container

    sink = _Sink()
    try:
        url = (f"http://127.0.0.1:{sink.port}/api/v2/spans" if exporter == "zipkin"
               else f"http://127.0.0.1:{sink.port}")
        c = Container.create(DictConfig({"TRACE_EXPORTER": exporter, "TRACER_URL": url,
                                         "LOG_LEVEL": "ERROR"}))
        worker = c.tracer._worker
        assert worker is not None and worker.is_alive()
        with c.tracer.span("outer") as outer:
            with c.tracer.span("inner"):
                pass
        c.close()
        assert not worker.is_alive()
    finally:
        sink.close()
    assert len(sink.bodies) == 1
    path, body = sink.bodies[0]
    if exporter == "zipkin":
        assert path == "/api/v2/spans"
        assert [s["name"] for s in body] == ["inner", "outer"]
        assert body[0]["parentId"] == outer.span_id
    else:
        assert path == "/v1/traces"
        spans = body["resourceSpans"][0]["scopeSpans"][0]["spans"]
        assert [s["name"] for s in spans] == ["inner", "outer"]
        assert spans[0]["parentSpanId"] == outer.span_id


# -- the engine's span timeline --------------------------------------------------------


CASES = {
    # plain and chunked prefill, prefix hits, preemption (13 pages: the
    # burst needs more)
    "paged": dict(kv_layout="paged", page_size=PAGE, total_pages=13, prefill_buckets=BUCKETS),
    # plain and chunked prefill on the slot cache
    "slot": dict(kv_layout="slot", prefill_buckets=BUCKETS),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_span_timeline_equals_the_jax_engine_s(tiny, case):
    """For each request of the same traffic: the engine spans under its
    server span — names in the order they began (``engine.queue_wait``,
    ``engine.prefill`` with ``chunk`` / ``swapin`` events, ``engine.decode``
    , ``engine.finish``, and a preempted request's extra prefill and decode
    spans), attribute keys and event names — equal the JAX engine's; every
    span is closed and the tokens are equal."""
    jeng, peng = engines(tiny, **CASES[case])
    try:
        jout, jservers = serve(jeng, WARM, BURST)
        pout, pservers = serve(peng, WARM, BURST)
        jspans = list(jeng.container.tracer._exporter.spans)
        pspans = list(peng.container.tracer._exporter.spans)
        if case == "paged":
            peng.check_page_refs()
    finally:
        jeng.stop()
        peng.stop()
    assert [o["tokens"] for o in pout] == [o["tokens"] for o in jout]
    got = [timeline(pspans, s) for s in pservers]
    want = [timeline(jspans, s) for s in jservers]
    assert got == want
    names = [n for t in got for n, _, _ in t]
    assert {"engine.queue_wait", "engine.prefill", "engine.decode", "engine.finish"} <= set(names)
    events = {e for t in got for _, _, ev in t for e in ev}
    assert "chunk" in events
    if case == "paged":
        keys = {k for t in got for n, ks, _ in t if n == "engine.prefill" for k in ks}
        assert "prefix.hit_pages" in keys  # a prefix hit
        assert any("preempted" in ks for t in got for _, ks, _ in t)  # a preemption


def test_engine_with_tracing_off_builds_no_span(tiny):
    """With ``TRACE_EXPORTER=none`` the engine starts no span and keeps no
    request trace, as the JAX engine (one branch a request); the flight
    recorder still records the request, its trace id None."""
    import gofr_tpu_torch.tracing as tracing
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    calls = []
    orig = tracing.Tracer.start_span

    def counting(self, *a, **k):
        calls.append(a)
        return orig(self, *a, **k)

    c = new_mock_container()
    eng = GenerateEngine(tiny[2], device="cpu", slots=2, max_len=64, container=c)
    tracing.Tracer.start_span = counting
    try:
        req = eng.submit([5, 3, 9], max_new_tokens=4)
        assert len(req.result(60)["tokens"]) == 4
    finally:
        tracing.Tracer.start_span = orig
        eng.stop()
    assert not calls and "_rt" not in req.kw
    assert c.flight.requests()[0]["trace_id"] is None


def test_a_failed_request_closes_its_spans_with_error(tiny):
    """A request that fails in the loop (an empty prompt) ends its open
    ``engine.queue_wait`` span with status ERROR, as the JAX engine's, and
    its flight entry names the error."""
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import GenerateEngine
    from gofr_tpu_torch.tracing import MemoryExporter, Tracer

    c = new_mock_container()
    c.tracer = Tracer(MemoryExporter())
    eng = GenerateEngine(tiny[2], device="cpu", slots=2, max_len=64, container=c)
    try:
        req = eng.submit([], max_new_tokens=4, timeout=60)
        with pytest.raises(ValueError):
            req.result(60)
    finally:
        eng.stop()
    assert [s for s in c.tracer._exporter.spans
            if s.name == "engine.queue_wait" and s.status == "ERROR"]
    assert c.flight.requests()[0]["error"] == "ValueError"
