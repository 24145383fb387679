"""The port engine's life cycle (gofr_tpu_torch.gpu.engine) held against the
JAX engine's (gofr_tpu/tpu/engine.py): restart after a crash of the device
loop, its budget, health and QoS during the backoff, and ``warmup``.

A crash fails the requests in slots and nothing queued; the requests after
it emit the JAX engine's greedy tokens, on the paged pool and the slot
cache, at pipeline depth 1 and 2. A spent budget reads DOWN and fails every
waiter. ``warmup()`` runs as many calls as the JAX engine compiles
programs for the same knobs, and leaves the pool, its refcounts, the
tables and the prefix cache as they were.
"""

import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

PROMPTS = [[5, 3, 9], [7, 1, 4, 2, 8], [11, 22, 33, 44]]
N_NEW = 6


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(7))
    return jcfg, params, params_from_jax(PortConfig.tiny(), jax.tree.map(np.asarray, params), "cpu")


def _jax_engine(tiny, **kw):
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine

    jcfg, params, _ = tiny
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    return GenerateEngine(llama, jcfg, params, new_mock_container(), page_size=8, **kw)


def _port_engine(tiny, container=None, **kw):
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    return GenerateEngine(tiny[2], device="cpu", page_size=8, container=container, **kw)


@pytest.fixture(scope="module")
def jax_tokens(tiny):
    """The JAX engine's greedy tokens for ``PROMPTS`` on each layout."""
    out = {}
    for layout in ("paged", "slot"):
        eng = _jax_engine(tiny, kv_layout=layout)
        try:
            out[layout] = [eng.generate(p, max_new_tokens=N_NEW, timeout=120)["tokens"]
                           for p in PROMPTS]
        finally:
            eng.stop()
    return out


def _one_fault(monkeypatch, msg="injected device fault"):
    """Make the port's next decode dispatch raise once, after the prefill
    has written the cache."""
    from gofr_tpu_torch.gpu import decode

    real = decode.decode_chunk
    left = {"n": 1}

    def flaky(*a, **kw):
        if left["n"]:
            left["n"] -= 1
            raise RuntimeError(msg)
        return real(*a, **kw)

    monkeypatch.setattr(decode, "decode_chunk", flaky)


def _restarts(metrics) -> float:
    counter = metrics.get("app_tpu_engine_restarts")
    return sum(counter._values.values()) if counter is not None else 0.0


@pytest.mark.quick
@pytest.mark.parametrize("layout,depth", [("paged", 1), ("paged", 2), ("slot", 1), ("slot", 2)])
def test_a_crash_fails_the_slots_and_the_queue_survives(tiny, jax_tokens, monkeypatch,
                                                        layout, depth):
    """A fault planted after the cache holds two prompts: both slot-resident
    requests fail with it, the third, queued behind them (2 slots), is
    served after the restart, and every request after it too, with the JAX
    engine's tokens; one restart is counted, health is UP again with
    ``restarts`` 1, and the pool's audit passes."""
    from gofr_tpu_torch.container import new_mock_container

    c = new_mock_container()
    eng = _port_engine(tiny, c, kv_layout=layout, pipeline_depth=depth)
    _one_fault(monkeypatch)
    try:
        with eng._state_lock:  # all three queued before the loop admits any
            reqs = [eng.submit(p, max_new_tokens=N_NEW, timeout=120) for p in PROMPTS]
        for r in reqs[:2]:
            with pytest.raises(RuntimeError, match="injected device fault"):
                r.result(timeout=120)
        assert reqs[2].result(timeout=120)["tokens"] == jax_tokens[layout][2]
        again = [eng.generate(p, max_new_tokens=N_NEW, timeout=120)["tokens"] for p in PROMPTS]
        assert again == jax_tokens[layout]
        assert _restarts(c.metrics) == 1
        assert eng.health_check() == {"status": "UP",
                                      "details": {"queue_depth": 0, "restarts": 1}}
        eng.check_page_refs()
    finally:
        eng.stop()


@pytest.mark.quick
def test_health_reads_degraded_during_the_backoff_as_the_jax_engine(tiny, monkeypatch):
    """Inside the backoff window (read from the restart hook, JAX's
    ``engine.restart`` chaos point) both engines read DEGRADED with
    ``restarting`` and the restart's number; afterwards both read UP with
    ``restarts`` 1."""
    jeng = _jax_engine(tiny, kv_layout="paged")
    real = jeng._decode_chunk
    left = {"n": 1}

    def flaky(*a, **kw):
        if left["n"]:
            left["n"] -= 1
            raise RuntimeError("injected device fault")
        return real(*a, **kw)

    seen = {}
    jeng._decode_chunk = flaky
    jeng._chaos_restart = lambda attempt: seen.setdefault("jax", jeng.health_check())
    try:
        with pytest.raises(Exception):
            jeng.generate(PROMPTS[0], max_new_tokens=N_NEW, timeout=60)
        jeng.generate(PROMPTS[0], max_new_tokens=N_NEW, timeout=60)
        jax_after = jeng.health_check()
    finally:
        jeng.stop()
    eng = _port_engine(tiny, kv_layout="paged")
    _one_fault(monkeypatch)
    eng._restart_hook = lambda attempt: seen.setdefault("port", eng.health_check())
    try:
        with pytest.raises(RuntimeError):
            eng.generate(PROMPTS[0], max_new_tokens=N_NEW, timeout=60)
        eng.generate(PROMPTS[0], max_new_tokens=N_NEW, timeout=60)
        port_after = eng.health_check()
    finally:
        eng.stop()
    assert seen["port"] == seen["jax"] == {
        "status": "DEGRADED", "details": {"restarting": True, "restarts": 1}}
    assert port_after["status"] == jax_after["status"] == "UP"
    assert port_after["details"]["restarts"] == jax_after["details"]["restarts"] == 1


@pytest.mark.quick
def test_the_budget_spent_reads_down_and_fails_at_once(tiny, monkeypatch):
    """``max_restarts=1`` (JAX's ``TestEngineSupervision``): the first
    crash takes the one restart, the second ends the loop; health reads
    DOWN and a later request fails at once, as on the JAX engine."""
    from gofr_tpu_torch.gpu import decode
    from gofr_tpu_torch.gpu.engine import EngineClosed

    def always(*_a, **_kw):
        raise RuntimeError("permanent device fault")

    monkeypatch.setattr(decode, "decode_chunk", always)
    eng = _port_engine(tiny, max_restarts=1)
    try:
        with pytest.raises(RuntimeError):
            eng.generate(PROMPTS[0], max_new_tokens=4, timeout=60)
        with pytest.raises(RuntimeError):
            eng.generate(PROMPTS[1], max_new_tokens=2, timeout=60)
        eng._thread.join(timeout=30)
        assert eng.health_check() == {"status": "DOWN",
                                      "details": {"error": "permanent device fault"}}
        t = time.monotonic()
        with pytest.raises(EngineClosed):
            eng.generate(PROMPTS[2], max_new_tokens=2, timeout=10)
        with pytest.raises(EngineClosed):  # only the loop runs a warmup
            eng.warmup()
        assert time.monotonic() - t < 1.0
    finally:
        eng.stop()


@pytest.mark.quick
def test_a_failed_reset_ends_down_with_no_waiter_hanging(tiny, monkeypatch):
    """A crash whose recovery faults too (a card whose fault is sticky
    fails every later call, the reset's included): the loop ends at once,
    DOWN, and every request, in a slot or queued, fails; none waits out
    its timeout."""
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    def broken_reset(self):
        raise RuntimeError("reset fault")

    _one_fault(monkeypatch)
    monkeypatch.setattr(GenerateEngine, "_reset_device_state", broken_reset)
    eng = _port_engine(tiny)
    try:
        with eng._state_lock:
            reqs = [eng.submit(p, max_new_tokens=N_NEW, timeout=60) for p in PROMPTS]
        t = time.monotonic()
        for r in reqs:
            with pytest.raises(RuntimeError, match="injected device fault"):
                r.result(timeout=60)
        assert time.monotonic() - t < 10.0
        eng._thread.join(timeout=30)
        assert not eng._thread.is_alive()
        assert eng.health_check()["status"] == "DOWN"
    finally:
        eng.stop()


@pytest.mark.quick
class TestShedDuringRestart:
    def test_restarting_engine_sheds_new_work(self):
        """``tests/test_qos.py:709`` against the port's QoS: while the loop
        backs off, new submissions get 503 + Retry-After, counted as a
        ``restart`` shed; admission resumes after the window."""
        from gofr_tpu_torch.container import new_mock_container
        from gofr_tpu_torch.http.errors import ServiceUnavailable
        from gofr_tpu_torch.qos import AdmissionController, QoSPolicy

        c = new_mock_container()
        ctrl = AdmissionController(QoSPolicy(shed_window_s=60.0), c.metrics)

        class FakeEngine:
            num_slots = 2
            _restarting = True

            def _backlog(self):
                return 0

        eng = FakeEngine()
        with pytest.raises(ServiceUnavailable) as err:
            ctrl.admit_engine(eng, None, None)
        assert err.value.status_code == 503
        assert err.value.retry_after and err.value.retry_after > 0
        assert ctrl.shedding and ctrl.health_check()["status"] == "DEGRADED"
        assert c.metrics.get("app_qos_rejected_total").value(
            reason="restart", qos_class="default") == 1
        assert c.metrics.get("app_qos_shed_total").value(reason="restart") == 1
        eng._restarting = False
        assert ctrl.admit_engine(eng, None, None).name == "default"

    def test_the_engine_sheds_while_it_backs_off(self, tiny, monkeypatch):
        """A real backoff: a submit made from the restart hook, inside the
        window, is shed 503 by the bound controller."""
        from gofr_tpu_torch.container import new_mock_container
        from gofr_tpu_torch.http.errors import ServiceUnavailable
        from gofr_tpu_torch.qos import AdmissionController, QoSPolicy

        c = new_mock_container()
        eng = _port_engine(tiny, c)
        c.register_engine("lm", eng)
        c.register_qos(AdmissionController(QoSPolicy(), c.metrics))
        _one_fault(monkeypatch)
        shed = []

        def hook(attempt):
            try:
                eng.submit(PROMPTS[1], max_new_tokens=2)
            except ServiceUnavailable as e:
                shed.append(e.status_code)

        eng._restart_hook = hook
        try:
            with pytest.raises(RuntimeError):
                eng.generate(PROMPTS[0], max_new_tokens=N_NEW, timeout=60)
            # the failed request completes before the backoff starts: wait
            # for the hook, then for the window's end, before new work
            deadline = time.monotonic() + 30
            while (not shed or eng._restarting) and time.monotonic() < deadline:
                time.sleep(0.01)
            assert eng.generate(PROMPTS[0], max_new_tokens=2, timeout=60)["tokens"]
        finally:
            eng.stop()
        assert shed == [503]


# -- warmup (engine.py:1685-1715, executor.py:258-381) ------------------------------

WARMUP_CASES = {
    "paged": dict(kv_layout="paged", max_len=32, max_prefill_batch=2),
    "slot": dict(kv_layout="slot", max_len=32, max_prefill_batch=2),
    "paged_int8": dict(kv_layout="paged", max_len=32, max_prefill_batch=1, kv_quantize="int8"),
    "paged_spec": dict(kv_layout="paged", max_len=32, max_prefill_batch=1, spec_tokens=2),
    "host_tier": dict(kv_layout="paged", max_len=32, max_prefill_batch=1, prefill_buckets=[16],
                      total_pages=12, prefix_host_mb=1),
}


def _pool_state(eng) -> dict:
    state = {k: v.clone() for k, v in vars(eng.cache).items()}
    if eng._table is not None:
        state.update(table=eng._table.copy(), refs=eng._page_refs.copy(),
                     free=sorted(eng._free_pages), slot_pages=[list(p) for p in eng._slot_pages],
                     prefix=sorted(eng._prefix._nodes) if eng._prefix is not None else None)
    return state


def _same(a: dict, b: dict) -> bool:
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif isinstance(x, np.ndarray):
            if not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


@pytest.mark.quick
@pytest.mark.parametrize("case", list(WARMUP_CASES))
def test_warmup_counts_as_jax_and_touches_nothing_live(tiny, case):
    """``warmup()`` returns the JAX engine's count for the same knobs; the
    pool's bytes, refcounts, free list, tables and prefix cache are as
    before it, after a request has left pages in the prefix cache; and the
    tokens after it equal the JAX engine's."""
    kw = WARMUP_CASES[case]
    prompt = list(range(1, 18))  # two full pages for the prefix cache
    jeng = _jax_engine(tiny, **kw)
    try:
        want_n = jeng.warmup()
        want = [jeng.generate(p, max_new_tokens=N_NEW, timeout=120)["tokens"]
                for p in [prompt] + PROMPTS]
    finally:
        jeng.stop()
    eng = _port_engine(tiny, **kw)
    try:
        first = eng.generate(prompt, max_new_tokens=N_NEW, timeout=120)["tokens"]
        before = _pool_state(eng)
        assert eng.warmup() == want_n
        assert _same(before, _pool_state(eng))
        eng.check_page_refs()
        got = [eng.generate(p, max_new_tokens=N_NEW, timeout=120)["tokens"] for p in PROMPTS]
    finally:
        eng.stop()
    assert [first] + got == want


@pytest.mark.quick
def test_engine_warmup_through_the_app_and_a_failed_one_is_logged(tiny):
    """``ENGINE_WARMUP=true``: ``App.arun`` warms the engine before the
    servers start and logs its count; a warmup that raises is logged with
    its traceback and the engine still serves."""
    import asyncio

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import new_mock_container

    def run(engine_patch=None) -> tuple[list, object, dict]:
        conf = {"ENGINE_WARMUP": "true", "HTTP_PORT": "0", "METRICS_PORT": "0"}
        c = new_mock_container(conf)
        app = App(config=DictConfig(conf), container=c)
        eng = _port_engine(tiny, c, max_len=32, max_prefill_batch=1)
        calls = []
        real = eng.warmup

        def warmup():
            calls.append(eng.counters["prefill_chunks"])
            if engine_patch is not None:
                raise RuntimeError(engine_patch)
            return real()

        eng.warmup = warmup
        app.serve_model("lm", engine=eng)

        async def main():
            ready = asyncio.Event()
            task = asyncio.ensure_future(app.arun(ready=ready))
            await ready.wait()
            out = await asyncio.get_running_loop().run_in_executor(
                None, lambda: eng.generate(PROMPTS[0], max_new_tokens=N_NEW, timeout=60))
            app.stop()
            await task
            return out

        out = asyncio.run(main())
        return calls, c.logger, out

    calls, logger, out = run()
    assert calls == [0] and len(out["tokens"]) == N_NEW
    assert any("model engine lm warmed (5 programs)" in line for line in logger.lines)
    calls, logger, out = run("warmup fault")
    assert calls == [0] and len(out["tokens"]) == N_NEW
    assert any("engine lm warmup failed" in line and "warmup fault" in line
               for line in logger.lines)
