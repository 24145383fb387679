"""The port's QoS plane (gofr_tpu_torch.qos: limiter, scheduler, admission;
the QoS middleware; the engine's QoS queue and bounded drain) held against
the JAX package's (gofr_tpu/qos, gofr_tpu/http/middleware, the engine's
``_submit`` and ``_drain_pending``).

Tolerances: exact. Token-bucket verdicts and retry hints at injected clocks
equal JAX's; ``QoSQueue`` hands items out in JAX's order for
hypothesis-drawn put/get sequences over mixed classes and deadlines;
``QoSPolicy.from_config`` builds JAX's policy; the admission controller's
verdicts (allowed, status, retry-after, reason, message; the errors it
raises) and its counters equal JAX's; an engine of 1 slot under QoS
finishes mixed-class traffic in the JAX engine's order; the App's 429 and
503 answer JAX's status, envelope and ``Retry-After``.
"""

import queue
import time

import jax
import numpy as np
import pytest

from tests.test_http_server import AppHarness, _free_port

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies


def _mods():
    import gofr_tpu.qos as jq
    import gofr_tpu_torch.qos as pq

    return jq, pq


# -- limiter ---------------------------------------------------------------------------


BUCKET_CASES = [
    (2.0, None, [(0.0, 1), (0.0, 1), (0.0, 1), (0.4, 1), (0.5, 1), (3.0, 2), (3.0, 1)]),
    (0.5, 3.0, [(0.0, 1), (0.0, 2), (0.1, 1), (2.0, 1), (10.0, 3), (10.0, 0.5)]),
    (0.0, None, [(0.0, 5), (0.0, 5)]),
    (10.0, 1.0, [(0.0, 1), (0.05, 1), (0.1, 1), (0.1, 2)]),
]


@pytest.mark.quick
@pytest.mark.parametrize("rate,burst,calls", BUCKET_CASES)
def test_token_bucket_verdicts_equal_jax_s(rate, burst, calls):
    """``TokenBucket.acquire(n, now)`` returns JAX's 0.0 or retry hint at
    every step, and ``peek`` JAX's token count."""
    jq, pq = _mods()
    t0 = 1000.0
    got, want = pq.TokenBucket(rate, burst), jq.TokenBucket(rate, burst)
    got._stamp = want._stamp = t0
    for dt, n in calls:
        assert got.acquire(n, now=t0 + dt) == want.acquire(n, now=t0 + dt)
        assert got.peek(now=t0 + dt) == want.peek(now=t0 + dt)


@pytest.mark.quick
def test_keyed_buckets_verdicts_and_lru_bound_equal_jax_s():
    """One policy fanned over keys: the same keys admitted and refused as
    JAX's (a slow refill, so the clock between calls cannot change a
    verdict), and the key space held at ``max_keys``."""
    jq, pq = _mods()
    got, want = pq.KeyedBuckets(0.001, 2.0, max_keys=3), jq.KeyedBuckets(0.001, 2.0, max_keys=3)
    keys = ["a", "a", "b", "a", "c", "d", "b", "a", "e", "a", "a"]
    g = [got.acquire(k) > 0 for k in keys]
    w = [want.acquire(k) > 0 for k in keys]
    assert g == w and any(g) and not all(g)
    assert len(got) == len(want) == 3
    assert pq.KeyedBuckets(0.0).acquire("x") == 0.0


# -- scheduler -------------------------------------------------------------------------


class Item:
    """The engine Request's shape as the queue reads it."""

    def __init__(self, i, cls, deadline):
        self.id = i
        self.kw = {} if cls is None else {"_qos_class": cls}
        self.deadline = deadline


CLASS_SPECS = ["", "interactive:8:16,default:4,batch:1:4", "gold:3,bronze:1"]
OPS = st.lists(st.one_of(
    st.tuples(st.just("put"), st.sampled_from([None, "interactive", "default", "batch", "gold",
                                               "bronze", "bogus"]),
              st.one_of(st.none(), st.integers(0, 5))),
    st.tuples(st.just("get"))), max_size=60)


@hypothesis.settings(max_examples=60, deadline=None)
@hypothesis.given(ops=OPS, spec=st.sampled_from(CLASS_SPECS), priority=st.booleans())
def test_qos_queue_hands_items_out_in_jax_s_order(ops, spec, priority):
    """Any put/get sequence — classes known, unknown and absent, deadlines
    or none — gets the same items in the same order from the port's queue
    as from JAX's, FIFO before ``set_policy`` and weighted-fair EDF after
    (the policy applied midway re-routes the backlog); ``depths`` and
    ``qsize`` agree after every step."""
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu_torch.config import DictConfig

    jq, pq = _mods()
    conf = {"QOS_CLASSES": spec} if spec else {}
    got, want = pq.QoSQueue(), jq.QoSQueue()
    half = len(ops) // 2
    for n, op in enumerate(ops):
        if priority and n == half:
            got.set_policy(pq.QoSPolicy.from_config(DictConfig(conf)))
            want.set_policy(jq.QoSPolicy.from_config(JaxConfig(conf)))
        if op[0] == "put":
            got.put(Item(n, op[1], op[2]))
            want.put(Item(n, op[1], op[2]))
        else:
            outs = []
            for q in (got, want):
                try:
                    outs.append(q.get_nowait().id)
                except queue.Empty:
                    outs.append(None)
            assert outs[0] == outs[1]
        assert got.qsize() == want.qsize() and got.depths() == want.depths()


@pytest.mark.quick
def test_wait_nonempty_takes_nothing():
    """The engine's idle wait: True once an item is queued, False after its
    timeout on an empty queue, and the item stays queued."""
    _, pq = _mods()
    q = pq.QoSQueue()
    t = time.monotonic()
    assert not q.wait_nonempty(0.05) and time.monotonic() - t >= 0.04
    q.put(Item(1, None, None))
    assert q.wait_nonempty(5.0) and q.qsize() == 1


# -- policy and admission --------------------------------------------------------------


POLICY_CONFIGS = [
    {}, {"QOS_CLASSES": "interactive:8:16,default:4,batch:1:4"},
    {"QOS_CLASSES": "gold:3,bronze", "QOS_DEFAULT_CLASS": "gold"},
    {"QOS_CLASSES": "a:2,b:1"},
    {"QOS_RATE_RPS": "5", "QOS_RATE_BURST": "7", "QOS_ROUTE_RPS": "2", "QOS_KEY_RPS": "3",
     "QOS_TENANT_RPS": "1.5", "QOS_MAX_QUEUE": "9", "QOS_SHED_WINDOW_S": "4",
     "QOS_SHED_ON_BURN": "true", "QOS_CLASS_HEADER": "X-Class", "QOS_TENANT_HEADER": "X-T"},
]


@pytest.mark.quick
@pytest.mark.parametrize("conf", POLICY_CONFIGS, ids=range(len(POLICY_CONFIGS)))
def test_policy_from_config_equals_jax_s(conf):
    """Every ``QOS_*`` key read as JAX reads it: classes (rank, weight,
    concurrency), default class, rates, backlog, shed window and headers;
    an unknown class resolves to the default."""
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu_torch.config import DictConfig

    jq, pq = _mods()
    got = pq.QoSPolicy.from_config(DictConfig(conf))
    want = jq.QoSPolicy.from_config(JaxConfig(conf))
    fields = [f for f in vars(want) if not f.startswith("_")]
    assert {f: getattr(got, f) for f in fields if f != "classes"} == {
        f: getattr(want, f) for f in fields if f != "classes"}
    assert [vars(c) for c in got.classes] == [vars(c) for c in want.classes]
    assert got.resolve("nope").name == want.resolve("nope").name


class FakeEngine:
    """An engine as the controller reads it: a backlog, a lane count, an
    SLO engine that says whether a class should shed."""

    def __init__(self, backlog=0, slots=2, shed=False):
        self.backlog, self.num_slots, self.shed = backlog, slots, shed
        self.slo = self

    def _backlog(self):
        return self.backlog

    def should_shed(self, _cls):
        return self.shed


def _verdict(fn):
    """A call's outcome as data: its return's fields, or the error's type
    name, message, status and retry hint."""
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 - the verdict is the point
        return (type(e).__name__, str(e), getattr(e, "status_code", None),
                getattr(e, "retry_after", None))
    return vars(out) if hasattr(out, "__dict__") and not hasattr(out, "weight") else out.name


def _controller(mod, registry_mod, conf, config_mod):
    return mod.AdmissionController(mod.QoSPolicy.from_config(config_mod.DictConfig(conf)),
                                   registry_mod.Registry())


ADMISSION = [
    # (config, engine kw, transport calls, engine calls (class, timeout), ewma step)
    ({"QOS_TENANT_RPS": "1"}, {}, [dict(tenant="t1"), dict(tenant="t1"), dict(tenant="t2")],
     [], 0.0),
    ({"QOS_KEY_RPS": "1", "QOS_ROUTE_RPS": "1"}, {},
     [dict(api_key="k", route="/a"), dict(api_key="k2", route="/a"), dict(api_key="k")], [], 0.0),
    ({"QOS_RATE_RPS": "1", "QOS_RATE_BURST": "2"}, {}, [{}, {}, {}], [], 0.0),
    ({"QOS_MAX_QUEUE": "3"}, {"backlog": 3}, [{}, dict(cls_name="batch")], [("batch", None)],
     0.25),
    ({"QOS_MAX_QUEUE": "3"}, {"backlog": 2}, [{}], [("interactive", None)], 0.25),
    ({}, {"backlog": 5, "slots": 2}, [], [("default", 0.5), ("default", 2.0), (None, None)], 0.25),
    ({"QOS_CLASSES": "interactive:8:1,default:4,batch:1"}, {},
     [], [("interactive", None), ("interactive", None), ("default", None)], 0.1),
    ({"QOS_SHED_ON_BURN": "true"}, {"shed": True}, [], [("batch", None)], 0.0),
]


class FrozenClock:
    """``time`` as the QoS modules read it, its monotonic clock stopped."""

    def __init__(self, t: float):
        self.t = t

    def monotonic(self) -> float:
        return self.t


@pytest.mark.quick
@pytest.mark.parametrize("case", ADMISSION, ids=range(len(ADMISSION)))
def test_admission_verdicts_and_counters_equal_jax_s(case, monkeypatch):
    """The same calls on a bound fake engine, both packages' clocks stopped
    at the same instant: each ``admit_transport`` decision (allowed,
    status, retry-after, reason, message) and each ``admit_engine`` class
    or error (type, message, status, retry hint) equal JAX's, and so do
    ``predicted_wait``, ``health_check`` and the admitted / rejected / shed
    counters."""
    import gofr_tpu.config as jconf
    import gofr_tpu.metrics as jmet
    import gofr_tpu.qos.limiter as jlim
    import gofr_tpu_torch.config as pconf
    import gofr_tpu_torch.metrics as pmet
    import gofr_tpu_torch.qos.limiter as plim

    jq, pq = _mods()
    for mod in (jlim, plim, jq, pq):
        monkeypatch.setattr(mod, "time", FrozenClock(5000.0))
    conf, eng_kw, transport, engine_calls, ewma = case
    results = []
    for mod, met, cfg in ((pq, pmet, pconf), (jq, jmet, jconf)):
        ctl = _controller(mod, met, conf, cfg)
        for name in ("app_qos_admitted_total", "app_qos_rejected_total", "app_qos_shed_total",
                     "app_request_deadline_exceeded_total"):
            ctl.metrics.new_counter(name)
        eng = FakeEngine(**eng_kw)
        ctl.bind_engine("lm", eng)
        ctl._ewma_step = ewma
        out = [_verdict(lambda kw=kw: ctl.admit_transport(**kw)) for kw in transport]
        out += [_verdict(lambda c=c, t=t: ctl.admit_engine(eng, c, t)) for c, t in engine_calls]
        out.append(ctl.predicted_wait(eng))
        health = ctl.health_check()
        out.append((health["status"], health["details"]["inflight"]))
        out.append(ctl.metrics.expose_text().split("\n# HELP app_request")[0])
        results.append(out)
    assert results[0] == results[1]


# -- the engine under QoS --------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(7))
    model = params_from_jax(PortConfig.tiny(), jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, model


MIXED = [("batch", [3 + i, 4, 5]) for i in range(6)] + [
    ("interactive", [40 + i, 2]) for i in range(3)] + [("default", [77, 78, 79 + i]) for i in range(3)]


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_one_slot_engine_finishes_mixed_classes_in_jax_s_order(tiny, layout):
    """One slot, QoS bound: a long batch request and 12 of three classes
    submitted at once (the loop held at its state lock, so no clock
    decides what the loop sees); the drain takes at most ``2 * slots +
    max_prefill_batch`` a turn in the queue's weighted-fair order, so
    interactive work overtakes batch work queued before it. The completion
    order and every request's tokens equal the JAX engine's."""
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.models import llama
    from gofr_tpu.qos import AdmissionController as JaxController
    from gofr_tpu.qos import QoSPolicy as JaxPolicy
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import GenerateEngine
    from gofr_tpu_torch.qos import AdmissionController, QoSPolicy

    jcfg, params, model = tiny
    kw = dict(slots=1, max_len=64, max_prefill_batch=2, kv_layout=layout)
    jc, pc = jax_container(), new_mock_container()
    jeng = JaxEngine(llama, jcfg, params, jc, decode_pipeline=2, **kw)
    peng = GenerateEngine(model, device="cpu", container=pc, **kw)
    jc.register_engine("lm", jeng)
    pc.register_engine("lm", peng)
    jc.register_qos(JaxController(JaxPolicy(), jc.metrics))
    pc.register_qos(AdmissionController(QoSPolicy(), pc.metrics))
    orders, outs = [], []
    try:
        for eng in (jeng, peng):
            order = []
            with eng._state_lock:
                hold = eng.submit([9, 9, 9], max_new_tokens=24, qos_class="batch")
                reqs = [eng.submit(p, max_new_tokens=4, qos_class=c) for c, p in MIXED]
            for i, r in enumerate(reqs):
                r.add_done_callback(lambda _r, i=i: order.append(i))
            outs.append([hold.result(300)["tokens"]] + [r.result(300)["tokens"] for r in reqs])
            orders.append(order)
    finally:
        jeng.stop()
        peng.stop()
    assert orders[1] == orders[0]
    assert outs[1] == outs[0]
    # an interactive request finished before some batch request queued before it
    first_interactive = min(orders[0].index(i) for i, (c, _) in enumerate(MIXED)
                            if c == "interactive")
    assert any(orders[0].index(i) > first_interactive for i, (c, _) in enumerate(MIXED)
               if c == "batch")


# -- the App's 429 / 503 ---------------------------------------------------------------


class Backlogged:
    """A served engine whose backlog sits at ``QOS_MAX_QUEUE``."""

    num_slots = 2

    def _backlog(self):
        return 4

    def health_check(self):
        return {"status": "UP"}

    def stop(self):
        pass


QOS_APP = {"QOS_ENABLED": "true", "QOS_TENANT_RPS": "1", "QOS_MAX_QUEUE": "4"}


def _port_app():
    from gofr_tpu_torch.app import new_testing

    app = new_testing({"HTTP_PORT": "0", "METRICS_PORT": "0", **QOS_APP})
    app.get("/ok", lambda ctx: "ok")
    return app


def _jax_app():
    import gofr_tpu.app as appmod
    from gofr_tpu.config import DictConfig
    from gofr_tpu.container import new_mock_container

    config = {"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port()), **QOS_APP}
    app = appmod.App(config=DictConfig(config), container=new_mock_container(config))
    app.get("/ok", lambda ctx: "ok")
    return app


@pytest.mark.quick
def test_app_429_and_503_answer_as_the_jax_app():
    """``QOS_ENABLED=true``: a tenant's second request within its budget
    answers 429, and with every engine at ``QOS_MAX_QUEUE`` any request
    answers 503, each with JAX's envelope and ``Retry-After``, before the
    handler; health passes through and lists ``qos``; the rejections are
    counted as JAX counts them."""
    import httpx

    got = []
    for app in (_port_app(), _jax_app()):
        out = []
        with AppHarness(app) as h, httpx.Client(base_url=h.base, timeout=30) as c:
            for hdr in ({"X-Tenant-ID": "t"}, {"X-Tenant-ID": "t"}):
                r = c.get("/ok", headers=hdr)
                out.append((r.status_code, r.json(), r.headers.get("Retry-After")))
            app.container.register_engine("lm", Backlogged())
            r = c.get("/ok", headers={"X-QoS-Class": "batch"})
            out.append((r.status_code, r.json(), r.headers.get("Retry-After")))
            r = c.get("/.well-known/health")
            # the JAX mock container also wires an in-memory pub/sub
            out.append((r.status_code, sorted(k for k in r.json()["data"]["services"]
                                              if k != "pubsub")))
            m = app.container.metrics
            out.append((m.get("app_qos_rejected_total").value(reason="tenant_rate",
                                                             qos_class="default"),
                        m.get("app_qos_rejected_total").value(reason="queue",
                                                             qos_class="batch"),
                        m.get("app_qos_shed_total").value(reason="queue")))
        got.append(out)
    assert got[0] == got[1]
    assert [s for s, *_ in got[0][:3]] == [200, 429, 503]
    assert "qos" in got[0][3][1]
