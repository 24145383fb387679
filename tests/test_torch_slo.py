"""The port's SLO plane (gofr_tpu_torch.metrics.slo and its wiring into the
container and the engine) held against the JAX package's
(gofr_tpu/metrics/slo.py, gofr_tpu/container/__init__.py:354-368, the
engine's feed points).

Tolerances: exact. For the same config, observations and injected clock,
the objectives, ``snapshot``, ``breaches``, ``should_shed``,
``health_check`` and the ``app_slo_*`` gauges equal JAX's. A burn turns
the container's health DEGRADED, as JAX's. For the same traffic the engine
feeds the same samples (counts per class and objective) as the JAX engine.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")


class Clock:
    def __init__(self, t: float = 10_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _engines(conf, clock):
    """(port SLOEngine, JAX SLOEngine) from ``conf``, each with a registry
    holding the three gauge families."""
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu.metrics import Registry as JaxRegistry
    from gofr_tpu.metrics.slo import SLOEngine as JaxSLO
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.metrics import Registry
    from gofr_tpu_torch.metrics.slo import SLOEngine

    out = []
    for slo, reg, cfg in ((SLOEngine, Registry, DictConfig), (JaxSLO, JaxRegistry, JaxConfig)):
        r = reg()
        for name in ("app_slo_attainment", "app_slo_burn_rate", "app_slo_budget_remaining"):
            r.new_gauge(name)
        out.append(slo.from_config(cfg(conf), metrics=r, now=clock))
    return out


CONFIGS = [
    {},
    {"SLO_TARGET": "0.9", "SLO_MIN_SAMPLES": "3", "SLO_BURN_THRESHOLD": "2",
     "SLO_INTERACTIVE_TTFT_MS": "50", "SLO_BATCH_E2E_MS": "0", "SLO_DEFAULT_AVAILABILITY": "0.5",
     "SLO_FAST_WINDOW_S": "30", "SLO_SLOW_WINDOW_S": "600"},
    {"QOS_CLASSES": "gold:3,bronze:1", "SLO_GOLD_TPOT_MS": "20", "SLO_BRONZE_TARGET": "0.8",
     "SLO_MIN_SAMPLES": "2", "SLO_GOLD_QUALITY": "0.9"},
]
# (advance seconds, class, objective, seconds or ok); objective
# "availability" takes a bool
SAMPLES = [
    (0.0, "interactive", "ttft", 0.01), (0.1, "interactive", "ttft", 0.2),
    (0.1, "interactive", "ttft", 3.0), (0.2, None, "e2e", 70.0), (0.0, "bogus", "tpot", 0.3),
    (1.0, "batch", "e2e", 1.0), (0.5, "interactive", "availability", False),
    (0.5, "default", "availability", True), (2.0, "interactive", "ttft", 2.5),
    (5.0, "gold", "tpot", 0.05), (0.0, "gold", "tpot", 0.01), (0.0, "bronze", "ttft", 40.0),
    (0.0, "bronze", "availability", False), (0.0, "gold", "availability", False),
    (40.0, "interactive", "ttft", 9.0), (0.0, "interactive", "ttft", 9.0),
    (0.0, "default", "tpot", 0.5), (0.0, "default", "tpot", 0.1), (0.0, "default", "tpot", 0.6),
]


@pytest.mark.quick
@pytest.mark.parametrize("conf", CONFIGS, ids=range(len(CONFIGS)))
def test_slo_engine_equals_jax_s_step_by_step(conf):
    """The same samples at the same clock: after each, the snapshot, the
    breaches, ``should_shed`` of every class and ``health_check`` equal
    JAX's; the objectives equal JAX's, and at the end so do the
    ``app_slo_*`` gauges a scrape writes."""
    clock = Clock()
    got, want = _engines(conf, clock)
    assert sorted(map(repr, got._trackers)) == sorted(map(repr, want._trackers))
    assert [vars(t.objective) if hasattr(t.objective, "__dict__") else repr(t.objective)
            for t in got._trackers.values()] == [
        vars(t.objective) if hasattr(t.objective, "__dict__") else repr(t.objective)
        for t in want._trackers.values()]
    classes = ["interactive", "default", "batch", "gold", "bronze", None, "bogus"]
    for dt, cls, obj, value in SAMPLES:
        clock.t += dt
        for eng in (got, want):
            if obj == "availability":
                eng.observe_outcome(cls, value)
            else:
                eng.observe(cls, obj, value)
        assert got.snapshot() == want.snapshot()
        assert got.breaches() == want.breaches()
        assert [got.should_shed(c) for c in classes] == [want.should_shed(c) for c in classes]
        assert got.health_check() == want.health_check()
    got.sample_gauges()
    want.sample_gauges()
    assert got.metrics.expose_text() == want.metrics.expose_text()


@pytest.mark.quick
def test_a_burn_degrades_the_container_s_health_as_jax_s():
    """A container whose SLO engine burns (its fast window past the
    threshold with enough samples) reads DEGRADED with the burning (class,
    objective) in its ``slo`` service, as the JAX container does; with
    ``SLO_ENABLED=false`` there is no ``slo`` service."""
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu_torch.container import new_mock_container

    class Up:
        def health_check(self):
            return {"status": "UP"}

    conf = {"SLO_MIN_SAMPLES": "2", "SLO_DEFAULT_TTFT_MS": "10"}
    got, want = new_mock_container(conf), jax_container(conf)
    for c in (got, want):
        c.register_engine("lm", Up())
        assert c.health()["status"] == "UP"
        for _ in range(3):
            c.slo.observe("default", "ttft", 1.0)
    gh, wh = got.health(), want.health()
    assert gh["status"] == wh["status"] == "DEGRADED"
    assert gh["services"]["slo"]["status"] == "DEGRADED"
    assert ([(b["class"], b["objective"], b["samples"]) for b in gh["services"]["slo"]["details"]
             ["burning"]] == [(b["class"], b["objective"], b["samples"]) for b in wh["services"]
                              ["slo"]["details"]["burning"]])
    assert new_mock_container({"SLO_ENABLED": "false"}).slo is None
    text = got.metrics.expose_text()
    assert 'app_slo_attainment{class="default",objective="ttft",window="fast"} 0' in text
    assert 'app_slo_burn_rate{class="default",objective="ttft",window="fast"} 100' in text


@pytest.mark.quick
def test_a_dead_engine_reads_down_beside_the_planes_where_jax_reads_degraded():
    """Under the default config (SLO on) and with QoS registered, an
    instance whose only engine is DOWN reads DOWN in the port, so the
    health route answers 503; the JAX container counts the UP planes and
    reads DEGRADED (200). This is the deviation recorded in ROADMAP Queue C.
    With a second engine UP, or an engine DEGRADED, both read DEGRADED; with
    the planes off the port reads DOWN."""
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.qos import AdmissionController as JaxAdmission
    from gofr_tpu.qos import QoSPolicy as JaxPolicy
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.qos import AdmissionController, QoSPolicy

    class Engine:
        def __init__(self, status):
            self.status = status

        def health_check(self):
            return {"status": self.status}

    def verdicts(conf, statuses, qos):
        out = []
        for make, adm, pol in ((new_mock_container, AdmissionController, QoSPolicy),
                               (jax_container, JaxAdmission, JaxPolicy)):
            c = make(conf)
            if qos:
                c.register_qos(adm(pol(), c.metrics))
            for i, st in enumerate(statuses):
                c.register_engine(f"lm{i}", Engine(st))
            out.append(c.health()["status"])
        return out

    assert verdicts({}, ["DOWN"], qos=True) == ["DOWN", "DEGRADED"]
    assert verdicts({}, ["DOWN"], qos=False) == ["DOWN", "DEGRADED"]
    assert verdicts({}, ["DOWN", "UP"], qos=True) == ["DEGRADED", "DEGRADED"]
    assert verdicts({}, ["DEGRADED"], qos=True) == ["DEGRADED", "DEGRADED"]
    assert verdicts({"SLO_ENABLED": "false"}, ["DOWN"], qos=False)[0] == "DOWN"
    assert verdicts({}, ["UP"], qos=True) == ["UP", "UP"]


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(7))
    model = params_from_jax(PortConfig.tiny(), jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, model


def test_the_engine_feeds_the_jax_engine_s_samples(tiny):
    """The same requests (classes given, one request failing) on both
    engines: every (class, objective) window holds as many samples as the
    JAX engine's — ttft, tpot and e2e of each completed request and the
    availability of every request — and the failure counts against
    availability."""
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    jcfg, params, model = tiny
    kw = dict(slots=2, max_len=64, max_prefill_batch=2, kv_layout="paged", page_size=8)
    jc, pc = jax_container(), new_mock_container()
    engines = (JaxEngine(llama, jcfg, params, jc, decode_pipeline=2, **kw),
               GenerateEngine(model, device="cpu", container=pc, **kw))
    traffic = [([5, 3, 9], "interactive"), ([7, 1], None), ([2, 2, 2, 2], "batch"), ([], "batch")]
    try:
        for eng in engines:
            for prompt, cls in traffic:
                extra = {"qos_class": cls} if cls else {}
                req = eng.submit(prompt, max_new_tokens=5, **extra)
                try:
                    req.result(120)
                except ValueError:
                    pass
    finally:
        for eng in engines:
            eng.stop()

    def counts(slo):
        return {c: {o: e["fast"]["total"] for o, e in objs.items()}
                for c, objs in slo.snapshot().items()}

    # totals only: whether a sample meets its threshold is wall time, and
    # the JAX engine's first calls compile
    assert counts(pc.slo) == counts(jc.slo)
    assert counts(pc.slo)["batch"]["availability"] == 2
    assert pc.slo.snapshot()["batch"]["availability"]["fast"]["good"] == 1
