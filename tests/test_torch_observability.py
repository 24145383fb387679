"""The port's flight recorder, engine metrics and ``/debug/*`` routes
(gofr_tpu_torch.metrics.flight, the ``app_tpu_*`` records of the engine and
its folds, the App's debug routes) held against the JAX package's
(gofr_tpu/metrics/flight.py, gofr_tpu/tpu/engine.py:402-675 and the
metric sites of its admission and folds, gofr_tpu/app.py:724-822).

Tolerances: exact for counts and structure; time fields are only held to
be present and non-negative (wall time differs by construction). For the
same traffic (submitted at once while the loop waits at its state lock)
on ``LlamaConfig.tiny()``: each request's flight entry has the JAX entry's
keys and its integer fields (slot, prompt length, preemptions, new
tokens, the prefix tiers); the counters (tokens, preemptions, the prefix
cache's lookups, misses, hit tokens by tier, evictions by tier and
swap-ins, speculation), the histogram sample counts and the pool gauges
equal the JAX engine's. The ``/debug/*`` responses have the JAX App's
shape. With no container, and with every plane on, the tokens are the
same.
"""

import time

import httpx
import jax
import numpy as np
import pytest

from tests.test_http_server import AppHarness, _free_port

torch = pytest.importorskip("torch")

PAGE = 8
PREFIX = [(7 * i + 3) % 256 for i in range(2 * PAGE)]
WARM = PREFIX + [1, 2, 3]
BURST = [PREFIX + [11, 12, 13, 14], PREFIX + list(range(40, 61)), PREFIX[:PAGE] + [21, 22, 23, 24],
         [5] * 9, list(range(90, 103)), [200, 17, 33], list(range(120, 138)), [1, 2], [9, 8, 7],
         list(range(60, 90))]
HOST_PROMPT = [(11 * i) % 190 + 1 for i in range(20)]
PRESSURE = [[(r * 37 + 13 * i) % 180 + 2 for i in range(18)] for r in range(5)]


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(7))
    model = params_from_jax(PortConfig.tiny(), jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, model


def _pair(tiny, **kw):
    """(JAX engine, port engine), each on its package's mock container."""
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    jcfg, params, model = tiny
    kw = {"slots": 4, "max_len": 64, "max_prefill_batch": 2, **kw}
    return (JaxEngine(llama, jcfg, params, jax_container(), decode_pipeline=2, **kw),
            GenerateEngine(model, device="cpu", container=new_mock_container(), **kw))


def _settle(eng) -> None:
    """Wait until the in-flight queue stays empty (a finished lane's chunk
    still folds, and is recorded)."""
    quiet, deadline = 0, time.monotonic() + 60
    while quiet < 3 and time.monotonic() < deadline:
        quiet = 0 if eng._dq else quiet + 1
        time.sleep(0.05)


def burst(eng, warm, prompts, n_new=10):
    """``warm`` alone, then ``prompts`` submitted at once; their tokens."""
    out = [eng.generate(warm, max_new_tokens=n_new, timeout=300)["tokens"]]
    _settle(eng)
    with eng._state_lock:
        reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    out += [r.result(300)["tokens"] for r in reqs]
    _settle(eng)
    return out


def spill_then_hit(eng, *_):
    """The host-tier traffic: a prompt, five whose pressure spills its
    pages, the prompt again (swapped back in)."""
    out = [eng.generate(HOST_PROMPT, max_new_tokens=6, timeout=300)["tokens"]]
    out += [eng.generate(p, max_new_tokens=4, timeout=300)["tokens"] for p in PRESSURE]
    out.append(eng.generate(HOST_PROMPT, max_new_tokens=6, timeout=300)["tokens"])
    _settle(eng)
    return out


@pytest.mark.quick
def test_flight_recorder_rings_equal_jax_s():
    """Bounded rings, newest first, ``limit`` honoured; a step entry's
    fields (the perf plane's when given) equal JAX's, less its clock."""
    from gofr_tpu.metrics.flight import FlightRecorder as JaxFlight
    from gofr_tpu_torch.metrics.flight import FlightRecorder

    got, want = FlightRecorder(max_requests=3, max_steps=2), JaxFlight(max_requests=3, max_steps=2)
    for f in (got, want):
        for i in range(5):
            f.record_request({"id": i})
        f.record_step("prefill", 0.0123456789, 0.5, ("prefill", 16, 2), 3, 1)
        f.record_step("decode", 0.02, 1.0, ("decode", 4, 8), 0, 0, device_s=0.0011111111,
                      bytes_=3e6, flops=1e6, bubble_s=0.00042)
        f.record_step("decode", 0.03, 0.25, ("decode", 4, 8), 1, 1, device_s=0.002)
    assert got.requests() == want.requests() == [{"id": 4}, {"id": 3}, {"id": 2}]
    assert got.requests(limit=1) == want.requests(limit=1)
    strip = lambda steps: [{k: v for k, v in s.items() if k != "at"} for s in steps]  # noqa: E731
    assert strip(got.steps()) == strip(want.steps())
    assert len(got.steps()) == 2


COUNTERS = ("app_tpu_tokens_total", "app_tpu_preemptions", "app_tpu_prefix_lookup_total",
            "app_tpu_prefix_miss_total", "app_tpu_prefix_hit_tokens",
            "app_tpu_prefix_evicted_pages_total", "app_tpu_prefix_swapin_pages_total",
            "app_tpu_spec_proposed", "app_tpu_spec_accepted", "app_tpu_spec_tokens_rejected_total",
            "app_tpu_spec_pages_trimmed_total")
HISTOGRAMS = ("app_tpu_queue_wait_seconds", "app_tpu_ttft_seconds", "app_tpu_tpot_seconds",
              "app_tpu_e2e_seconds", "app_tpu_step_seconds", "app_tpu_batch_occupancy",
              "app_tpu_step_device_seconds", "app_tpu_prefix_swapin_seconds")
GAUGES = ("app_tpu_kv_pages_free", "app_tpu_prefix_cached_pages", "app_tpu_prefix_host_pages",
          "app_tpu_queue_depth")


def _readings(metrics) -> dict:
    out = {}
    for name in COUNTERS + GAUGES:
        m = metrics.get(name)
        out[name] = {ls: v for ls, v in m._values.items()}
    for name in HISTOGRAMS:
        m = metrics.get(name)
        out[name] = dict(m._totals)
    return out


SCENARIOS = {
    # chunked prefill, prefix hits (both routes), preemption
    "paged": (dict(kv_layout="paged", page_size=PAGE, total_pages=13, prefill_buckets=[8, 16]),
              burst),
    # the host tier: spills and a swap-in
    "paged_host_tier": (dict(kv_layout="paged", page_size=PAGE, total_pages=12, prefix_host_mb=8.0),
                        spill_then_hit),
    # the slot cache with prompt-lookup speculation
    "slot_spec": (dict(kv_layout="slot", spec_tokens=2, prefill_buckets=[8, 16]), burst),
}
TIME_FIELDS = ("e2e_s", "queue_wait_s", "ttft_s", "tpot_s")
INT_FIELDS = ("slot", "prompt_len", "preemptions", "new_tokens", "prefix", "finish_reason",
              "qos_class", "weights_epoch")


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_flight_entries_and_engine_metrics_equal_the_jax_engine_s(tiny, scenario):
    """The same traffic: equal tokens; each request's flight entry has the
    JAX entry's keys (the per-phase device seconds' too), equal integer
    fields and non-negative times; the counters, histogram counts and pool
    gauges equal the JAX engine's."""
    kw, traffic = SCENARIOS[scenario]
    jeng, peng = _pair(tiny, **kw)
    try:
        want_tokens = traffic(jeng, WARM, BURST)
        got_tokens = traffic(peng, WARM, BURST)
        if kw["kv_layout"] == "paged":
            peng.check_page_refs()
    finally:
        jeng.stop()
        peng.stop()
    assert got_tokens == want_tokens
    got = sorted(peng.container.flight.requests(), key=lambda e: e["id"])
    want = sorted(jeng.container.flight.requests(), key=lambda e: e["id"])
    assert len(got) == len(want) == len(got_tokens)
    for g, w in zip(got, want):
        assert set(g) - {"id", "completed_at"} == set(w) - {"id", "completed_at"}
        assert {f: g.get(f) for f in INT_FIELDS} == {f: w.get(f) for f in INT_FIELDS}
        assert set(g.get("device", {})) == set(w.get("device", {}))
        for f in TIME_FIELDS:
            assert (g.get(f) is None) == (w.get(f) is None) and (g.get(f) or 0) >= 0
        assert all(v >= 0 for v in g.get("device", {}).values())
    assert _readings(peng.metrics) == _readings(jeng.metrics)
    if scenario == "paged":
        assert peng.metrics.get("app_tpu_preemptions").value() >= 1
    if scenario == "paged_host_tier":
        assert peng.metrics.get("app_tpu_prefix_swapin_pages_total").value() == 2
    if scenario == "slot_spec":
        assert peng.metrics.get("app_tpu_spec_proposed").value() > 0


def test_tokens_are_the_same_with_no_container_and_every_plane_on(tiny):
    """The direct engine (no container: a private registry, every plane
    off) and one with every plane on (memory tracer, flight, SLO, perf,
    QoS bound) give the same tokens for the same traffic."""
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import GenerateEngine
    from gofr_tpu_torch.qos import AdmissionController, QoSPolicy
    from gofr_tpu_torch.tracing import MemoryExporter, Tracer

    kw = dict(slots=4, max_len=64, max_prefill_batch=2, kv_layout="paged", page_size=PAGE,
              total_pages=13, prefill_buckets=[8, 16])
    bare = GenerateEngine(tiny[2], device="cpu", **kw)
    c = new_mock_container()
    c.tracer = Tracer(MemoryExporter())
    full = GenerateEngine(tiny[2], device="cpu", container=c, **kw)
    c.register_engine("lm", full)
    c.register_qos(AdmissionController(QoSPolicy(), c.metrics))
    try:
        assert bare.perf is None and bare.flight is None and bare.tracer is None
        assert full.perf is not None and full.qos is not None
        plain = burst(bare, WARM, BURST)
        planes = burst(full, WARM, BURST)
    finally:
        bare.stop()
        full.stop()
    assert planes == plain
    assert c.tracer._exporter.spans and c.flight.steps() and c.slo.snapshot()


# -- /debug/* ---------------------------------------------------------------------------


def _apps(tiny):
    """The JAX App and the port's under ``APP_ENV=DEBUG``, each serving the
    tiny model on a paged pool behind ``POST /generate``."""
    import gofr_tpu.app as jax_app
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.app import new_testing
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    jcfg, params, model = tiny
    kw = dict(slots=2, max_len=64, max_prefill_batch=2, kv_layout="paged", page_size=PAGE)
    conf = {"APP_ENV": "DEBUG", "PROFILER_PORT": "0", "HTTP_PORT": str(_free_port()),
            "METRICS_PORT": str(_free_port())}
    japp = jax_app.App(config=JaxConfig(conf), container=jax_container(conf))
    japp.serve_model("lm", engine=JaxEngine(llama, jcfg, params, japp.container, **kw))
    papp = new_testing({**conf, "HTTP_PORT": "0", "METRICS_PORT": "0"})
    papp.serve_model("lm", engine=GenerateEngine(model, device="cpu", container=papp.container,
                                                 **kw))

    async def generate(ctx):
        body = ctx.bind(dict)
        return await ctx.agenerate("lm", body["prompt"], max_new_tokens=4)

    for app in (japp, papp):
        app.post("/generate", generate)
    return japp, papp


def _shape(x, depth=0):
    """A JSON value's structure: dict keys (recursively, to a depth), list
    element shapes merged, leaves by kind."""
    if isinstance(x, dict):
        if depth > 3:
            return "dict"
        return {k: _shape(v, depth + 1) for k, v in x.items()}
    if isinstance(x, list):
        shapes = [_shape(v, depth + 1) for v in x]
        return [shapes[0]] if shapes and all(s == shapes[0] for s in shapes) else shapes
    return "number" if isinstance(x, (int, float)) and not isinstance(x, bool) else type(x).__name__


def test_debug_routes_answer_in_the_jax_app_s_shape(tiny):
    """Under ``APP_ENV=DEBUG`` both Apps serve ``/debug/requests``,
    ``/debug/engine`` and ``/debug/perf`` after the same two requests: the
    same counts and keys — request entries, step entries (less the JAX
    controller's ``knobs``), each engine's snapshot (less JAX's
    ``restarts`` and autotune report), the perf plane's per-engine view,
    its page-pool keys (JAX's per-device byte names read as the one card's)
    and the rollup — and ``?n=1`` limits both. Outside DEBUG the routes are
    404."""
    japp, papp = _apps(tiny)
    got = []
    for app in (papp, japp):
        with AppHarness(app) as h, httpx.Client(base_url=h.base, timeout=120) as c:
            for p in ([5, 3, 9], list(range(1, 12))):
                assert c.post("/generate", json={"prompt": p}).status_code == 201
            _settle(app.container.engine("lm"))
            reqs = c.get("/debug/requests").json()["data"]
            steps = c.get("/debug/engine").json()["data"]
            perf = c.get("/debug/perf").json()["data"]
            one = c.get("/debug/requests", params={"n": "1"}).json()["data"]
        for s in steps["steps"]:
            s.pop("knobs", None)
        eng = steps["engines"]["lm"]
        eng["details"].pop("restarts", None)
        eng.pop("autotune", None)
        got.append({"requests": (reqs["count"], sorted({k for e in reqs["requests"] for k in e})),
                    "one": one["count"],
                    "steps": (steps["count"] > 0, sorted({k for e in steps["steps"] for k in e})),
                    "engine": _shape(eng),
                    "perf": _shape({k: v for k, v in perf["engines"]["lm"].items()
                                    if k not in ("kinds", "adapters", "page_pool")}),
                    "perf_kinds": sorted(perf["engines"]["lm"]["kinds"]),
                    # JAX names its bytes per device of a tp-sharded pool;
                    # the port serves one card (and adds the prefix tiers)
                    "page_pool": sorted({{"page_bytes": "page_bytes_device",
                                          "pool_bytes": "pool_bytes_device"}.get(k, k)
                                         for k in perf["engines"]["lm"]["page_pool"]}
                                        - {"kv_shards", "prefix_pages", "prefix_host_pages",
                                           "prefix_host_bytes"}),
                    "rollup": sorted(perf["rollup"])})
    assert got[0] == got[1]
    assert got[0]["requests"][0] == 2 and got[0]["one"] == 1
    from gofr_tpu_torch.app import new_testing

    plain = new_testing({"HTTP_PORT": "0", "METRICS_PORT": "0"})
    plain.get("/ok", lambda ctx: "ok")
    with AppHarness(plain) as h:
        assert httpx.get(f"{h.base}/debug/perf", timeout=30).status_code == 404
