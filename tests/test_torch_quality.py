"""The port's quality plane and anomaly capture (gofr_tpu_torch.metrics.
quality, metrics.slo.CaptureWatcher, the App's /debug/quality and
/debug/profile) held against the JAX package's.

Scoring helpers: the fake-quantized K/V round trips bit for bit, the
teacher-forced rows of the bf16, int8, int4 and adapter arms within 1e-4
in f32, the divergence report equal on the same rows. The state machine on
a stub model, as tests/test_quality.py holds JAX's, and the same seeded
schedule. On engines: shadow scoring leaves every emitted token as it was,
samples the JAX engine's requests and reports the JAX engine's divergence,
on the paged pool, the int8 pool and the slot cache, with speculation on
and off; the capture bundle has the JAX bundle's files and keys.
"""

import json
import os
import re
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from tests.test_http_server import AppHarness

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.quick

PROMPTS = [[2, 5, 7, 11], [3, 4, 9], [1, 8, 6, 2, 9], list(range(20, 40))]


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(7))
    return jcfg, params, params_from_jax(PortConfig.tiny(), jax.tree.map(np.asarray, params), "cpu")


def _rows(seed: int, t: int = 4, vocab: int = 11) -> np.ndarray:
    return np.random.RandomState(seed).randn(t, vocab).astype(np.float32)


# -- the scoring helpers -------------------------------------------------------------


@pytest.mark.parametrize("case", ["agree", "diverge", "arms_agree_live_diverged"])
def test_divergence_report_equals_jax(case):
    """tests/test_quality.py's three report cases, equal to JAX's report."""
    from gofr_tpu.metrics import quality as jq
    from gofr_tpu_torch.metrics import quality as pq

    ref = _rows(1)
    serving, emitted = ref.copy(), ref.argmax(axis=-1)
    if case == "diverge":
        serving, emitted = _rows(2), emitted.copy()
        emitted[2] = (emitted[2] + 1) % ref.shape[1]
        emitted[3] = (emitted[3] + 3) % ref.shape[1]
    elif case == "arms_agree_live_diverged":
        emitted = (emitted + 1) % ref.shape[1]
    got = pq.divergence_report(serving, ref, emitted)
    assert got == jq.divergence_report(serving, ref, emitted)
    want = {"agree": (1.0, -1), "diverge": (0.5, 2), "arms_agree_live_diverged": (0.0, 0)}[case]
    assert (got["top1_agree"], got["first_divergence"]) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_rows_equal_jax_bit_for_bit(dtype):
    """``ops.kvcache.fake_quant_row`` (int8) and ``ops.quant.
    fake_quant_row_int4``, each through the pool's bf16 scale, equal JAX's
    (kvcache.py:148, quant.py:147) bit for bit."""
    import jax.numpy as jnp

    from gofr_tpu.ops.kvcache import fake_quant_row as jax_fq8
    from gofr_tpu.ops.quant import fake_quant_row_int4 as jax_fq4
    from gofr_tpu_torch.models.llama import tensor_from_numpy
    from gofr_tpu_torch.ops.kvcache import fake_quant_row
    from gofr_tpu_torch.ops.quant import fake_quant_row_int4

    x = jnp.asarray(np.random.RandomState(3).randn(3, 5, 2, 16) * 4, getattr(jnp, dtype))
    xt = tensor_from_numpy(np.asarray(x))
    for jfn, pfn in ((jax_fq8, fake_quant_row), (jax_fq4, fake_quant_row_int4)):
        want = tensor_from_numpy(np.asarray(jfn(x)))
        got = pfn(xt)
        assert got.dtype == want.dtype and torch.equal(got, want)


def _arms(tiny, arm: str):
    """(JAX hooks, port hooks) of one serving arm."""
    from gofr_tpu.metrics import quality as jq
    from gofr_tpu_torch.metrics import quality as pq

    if arm == "adapter":
        rng = np.random.RandomState(5)
        a = rng.randn(64, 4).astype(np.float32) * 0.1
        b = rng.randn(4, 256).astype(np.float32) * 0.1
        return dict(head_fn=jq.make_adapter_head_fn(a, b, 2.0)), dict(
            head_fn=pq.make_adapter_head_fn(a, b, 2.0))
    return (dict(attn_fn=jq.make_serving_attn_fn(arm)),
            dict(attn_fn=pq.make_serving_attn_fn(arm)))


@pytest.mark.parametrize("arm", ["bf16", "int8", "int4", "adapter"])
def test_teacher_forced_rows_equal_jax(tiny, arm):
    """The rows of each arm equal JAX's ``teacher_forced_rows(llama, cfg,
    params, ...)`` within 1e-4 in f32, at a full bucket and a padded one
    (24 tokens in a bucket of 32); each differs from the reference arm
    where the arm changes the computation."""
    from gofr_tpu.metrics import quality as jq
    from gofr_tpu.models import llama
    from gofr_tpu_torch.metrics import quality as pq

    jcfg, params, model = tiny
    jkw, pkw = _arms(tiny, arm)
    for prompt, emitted in (([2, 5, 7, 11], [3, 4, 9]), (list(range(1, 17)), [9] * 8)):
        want = jq.teacher_forced_rows(llama, jcfg, params, prompt, emitted, **jkw)
        got = pq.teacher_forced_rows(model, prompt, emitted, **pkw)
        assert got.shape == want.shape == (len(emitted), jcfg.vocab_size)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        ref = pq.teacher_forced_rows(model, prompt, emitted)
        assert (got == ref).all() == (arm == "bf16")
        assert (got == pq.teacher_forced_rows(model, prompt, emitted, **pkw)).all()


def test_scoring_hooks_as_jax(tiny):
    """One attention function per format, none for a dense pool, a
    ValueError for an unknown one; a zero adapter leaves the rows bit for
    bit; empty sides raise."""
    from gofr_tpu_torch.metrics import quality as pq

    _, _, model = tiny
    assert pq.make_serving_attn_fn("bf16") is None and pq.make_serving_attn_fn("") is None
    assert pq.make_serving_attn_fn("int8") is pq.make_serving_attn_fn("int8")
    with pytest.raises(ValueError):
        pq.make_serving_attn_fn("fp8")
    zero = pq.make_adapter_head_fn(np.zeros((64, 2), np.float32), np.zeros((2, 256), np.float32),
                                   2.0)
    base = pq.teacher_forced_rows(model, [2, 5], [3, 4])
    assert (pq.teacher_forced_rows(model, [2, 5], [3, 4], head_fn=zero) == base).all()
    for prompt, emitted in (([], [1]), ([1], [])):
        with pytest.raises(ValueError):
            pq.teacher_forced_rows(model, prompt, emitted)


# -- the plane's state machine (tests/test_quality.py:163-262) ------------------------


class _Stub:
    """A model whose logits favour token (position % vocab), read through
    the head hook, as JAX's stub family; the serving arm nudges them."""

    def __init__(self, vocab: int = 8, fail: BaseException | None = None):
        self.cfg = SimpleNamespace(max_seq_len=64)
        self.device = torch.device("cpu")
        self.vocab, self.fail = vocab, fail

    def forward(self, tokens, lengths=None, attn_fn=None, head_fn=None):
        if self.fail is not None:
            raise self.fail
        b, s = tokens.shape
        out = torch.zeros(b, s, self.vocab)
        out[:, torch.arange(s), torch.arange(s) % self.vocab] = 5.0
        if attn_fn is not None:
            out = out + 0.01
        return head_fn(out, torch.eye(self.vocab))


def _plane(**kw):
    from gofr_tpu_torch.metrics.quality import QualityPlane

    stub = kw.pop("model", _Stub())
    kw = {"rate": 1.0, "seed": 3, "kv_dtype": "bf16", **kw}
    return QualityPlane(lambda: stub, **kw)


def test_plane_samples_scores_and_drops_as_jax():
    """Rate 0 samples nothing; the pending queue drops its oldest; one arm
    a step; a snapshot trims its replay payloads."""
    p = _plane(rate=0.0)
    assert p.maybe_capture([1, 2], [3, 4]) is False and p.pending == 0 and p.step() is False
    p = _plane(max_pending=2)
    for i in range(5):
        assert p.maybe_capture([1, 2], [3, 4], request_id=f"r{i}")
    assert p.pending == 2 and p.dropped == 3
    assert p.step() is True and p.samples == 0 and p.pending == 2
    assert p.step() is True and p.samples == 1 and p.pending == 1
    while p.step():
        pass
    assert [e["request_id"] for e in p.snapshot()["recent"]] == ["r3", "r4"]
    full = p.snapshot()["recent"][0]
    assert full["prompt"] == [1, 2] and full["emitted"] == [3, 4]
    slim = p.snapshot(replay=False)["recent"][0]
    assert "prompt" not in slim and "emitted" not in slim and slim["report"]["tokens"] == 2


def test_plane_counts_scorer_faults_and_raises_kernel_faults():
    """A scorer fault is counted and its sample dropped, never raised; a
    kernel that fails to launch is not absorbed: it reaches the loop."""
    from gofr_tpu_torch.ops.cuda import KernelError

    p = _plane(model=_Stub(fail=RuntimeError("injected scorer fault")))
    p.maybe_capture([1, 2], [3, 4])
    assert p.step() is True
    assert p.errors == 1 and p.samples == 0 and p.pending == 0
    p = _plane(model=_Stub(fail=KernelError("flash_attention: CUDA error 700")))
    p.maybe_capture([1, 2], [3, 4])
    with pytest.raises(KernelError):
        p.step()
    assert p.errors == 0 and p.samples == 0 and p.pending == 0


@pytest.mark.parametrize("msg", [
    "CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when calling `cublasGemmEx( handle, opa, opb)`",
    "CUDA error: an illegal memory access was encountered",
    "cuDNN error: CUDNN_STATUS_EXECUTION_FAILED",
])
def test_plane_raises_device_faults_that_come_as_runtime_errors(msg):
    """A card fault that PyTorch raises as a plain RuntimeError (a cuBLAS
    status from a library product, a sticky CUDA error) reaches the loop
    as a kernel's does; the errors counter does not absorb it."""
    p = _plane(model=_Stub(fail=RuntimeError(msg)))
    p.maybe_capture([1, 2], [3, 4])
    with pytest.raises(RuntimeError, match="CUDA error|cuDNN error"):
        p.step()
    assert p.errors == 0 and p.samples == 0 and p.pending == 0


def test_plane_labels_metrics_and_slo_as_jax():
    """Labels, counters and the SLO feed (test_quality.py:219): the stub's
    rows at positions 1..2 agree with emitted [1, 2]."""
    from gofr_tpu_torch.container import new_mock_container

    c = new_mock_container({"SLO_INTERACTIVE_QUALITY": "0.99",
                            "QOS_CLASSES": "interactive,default"})
    seen = []
    slo = SimpleNamespace(observe_quality=lambda cls_name, ok: seen.append((cls_name, ok)))
    p = _plane(metrics=c.metrics, slo=slo, kv_dtype="int8", backend_fn=lambda: "cuda")
    p.maybe_capture([1, 2], [1, 2], qos_class="interactive")
    while p.step():
        pass
    assert p.samples == 1 and seen == [("interactive", True)]
    labels = {"kv_dtype": "int8", "backend": "cuda", "adapter": "base"}
    for name in ("app_tpu_quality_samples_total", "app_tpu_quality_good_total"):
        counter = c.metrics.get(name)
        assert counter.value(**labels) == 1.0 and sum(counter._values.values()) == 1.0
    # the port's SLO engine takes the samples under its quality objective
    c.slo.observe_quality("interactive", False)
    assert c.slo.snapshot()["interactive"]["quality"]["fast"]["total"] == 1


def test_plane_draws_the_jax_schedule():
    """The same seed and completion order pick the same requests."""
    from gofr_tpu.metrics.quality import QualityPlane as JaxPlane

    jp = JaxPlane(None, None, lambda: None, rate=0.37, seed=11)
    pp = _plane(rate=0.37, seed=11)
    picks = [(jp.maybe_capture([1], [2]), pp.maybe_capture([1], [2])) for _ in range(64)]
    assert [a for a, _ in picks] == [b for _, b in picks] and 0 < sum(a for a, _ in picks) < 64


# -- on engines ---------------------------------------------------------------------

ENGINE_CASES = {
    "paged": dict(kv_layout="paged", page_size=8, total_pages=64),
    "paged_int8_spec": dict(kv_layout="paged", page_size=8, total_pages=64, kv_quantize="int8",
                            spec_tokens=2),
    "slot_spec": dict(kv_layout="slot", spec_tokens=2),
    "slot_int8": dict(kv_layout="slot", kv_quantize="int8"),
}


def _serve(eng) -> list:
    return [eng.generate(p, max_new_tokens=6, timeout=120)["tokens"] for p in PROMPTS]


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_shadow_scoring_is_invisible_and_reports_as_jax(tiny, tmp_path, case):
    """Rate 0 builds no plane; rate 1 (0.6 with a seed on the paged pool)
    emits rate 0's tokens and the JAX engine's, samples the JAX engine's
    requests, scores each without error and reports JAX's divergence
    (f32: report values within 1e-4, agreement masks equal), with the
    ``cuda``/``plain`` backend label where JAX says ``xla``. With
    ``SLO_CAPTURE`` both containers write a bundle for the same breach,
    with the same files and the same keys."""
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    jcfg, params, model = tiny
    kw = dict(slots=2, max_len=64, **ENGINE_CASES[case])
    rate = {"quality_shadow_rate": 0.6, "quality_seed": 4} if case == "paged" else {
        "quality_shadow_rate": 1.0}
    conf = {"SLO_CAPTURE": "true", "SLO_CAPTURE_MIN_INTERVAL_S": "0.01"}
    off = GenerateEngine(model, device="cpu", **kw)
    try:
        want = _serve(off)
        assert off._quality is None and off.quality_snapshot() is None
    finally:
        off.stop()
    jc = jax_container({**conf, "SLO_CAPTURE_DIR": str(tmp_path / "jax")})
    jeng = JaxEngine(llama, jcfg, params, jc, **kw, **rate)
    jc.register_engine("lm", jeng)
    pc = new_mock_container({**conf, "SLO_CAPTURE_DIR": str(tmp_path / "port")})
    eng = GenerateEngine(model, device="cpu", container=pc, **kw, **rate)
    pc.register_engine("lm", eng)
    try:
        assert _serve(jeng) == want
        assert _serve(eng) == want
        assert jeng._quality.drain(120) and eng._quality.drain(120)
        js, ps = jeng.quality_snapshot(), eng.quality_snapshot()
        breach = [{"class": "default", "objective": "quality", "window": "fast",
                   "burn_rate": 50.0}]
        bundles = [c.slo_capture.on_breach(breach) for c in (jc, pc)]
    finally:
        jeng.stop()
        eng.stop()
    assert ps["errors"] == js["errors"] == 0 and ps["samples"] == js["samples"] > 0
    assert set(ps) == set(js) and ps["backend"] == "plain" and ps["kv_dtype"] == js["kv_dtype"]
    assert [e["prompt"] for e in ps["recent"]] == [e["prompt"] for e in js["recent"]]
    for pe, je in zip(ps["recent"], js["recent"]):
        assert set(pe) == set(je) and pe["emitted"] == je["emitted"] and pe["ok"] == je["ok"]
        assert pe["labels"] == {**je["labels"], "backend": "plain"}
        pr, jr = pe["report"], je["report"]
        assert pr["agree"] == jr["agree"] and pr["first_divergence"] == jr["first_divergence"]
        for key in ("logprob_delta_mean_abs", "logprob_delta_max_abs", "kl_mean", "kl_max"):
            assert abs(pr[key] - jr[key]) < 1e-4, (key, pr[key], jr[key])
    names = [os.path.basename(b) for b in bundles]
    assert all(re.fullmatch(r"slo-capture-\d{8}-\d{6}-001", n) for n in names)
    docs = []
    for b in bundles:
        assert sorted(os.listdir(b)) == ["bundle.json"]
        with open(os.path.join(b, "bundle.json")) as f:
            docs.append(json.load(f))
    jdoc, pdoc = docs
    assert set(pdoc) == set(jdoc) and set(pdoc["flight"]) == set(jdoc["flight"])
    assert pdoc["reason"] == jdoc["reason"] == breach
    assert set(pdoc["quality"]["lm"]) == set(jdoc["quality"]["lm"])
    assert set(pdoc["quality"]["lm"]["replay"]) == set(jdoc["quality"]["lm"]["replay"])
    assert set(pdoc["engines"]["lm"]["details"]) <= set(jdoc["engines"]["lm"]["details"])


# -- the capture watcher (tests/test_slo.py:317-385) ---------------------------------


class _Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _slo(clock):
    from gofr_tpu_torch.metrics.slo import Objective, SLOEngine

    return SLOEngine([Objective("interactive", "ttft", 0.98, 0.25),
                      Objective("batch", "ttft", 0.98, 30.0)], default_class="batch",
                     rank={"interactive": 0, "batch": 1}, min_samples=10, burn_threshold=2.0,
                     check_interval_s=0.0, now=clock)


def test_capture_watcher_throttles_bursts_and_bundles(tmp_path):
    """One bundle, then suppressed until a token refills; a burst of 2
    allows two; a bundle holds the reason, the SLO windows and the flight
    rings; the breach listener fires from ``observe``."""
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.metrics.slo import CaptureWatcher

    clock = _Clock()
    c = new_mock_container()
    slo = _slo(clock)
    w = CaptureWatcher(c, slo, out_dir=str(tmp_path / "a"), min_interval_s=600.0, now=clock,
                       clock=clock)
    breach = [{"class": "interactive", "objective": "ttft", "window": "fast", "burn_rate": 50.0}]
    assert w.on_breach(breach) is not None
    assert w.on_breach(breach) is None and w.on_breach(breach) is None
    assert c.metrics.get("app_slo_captures_total").value() == 1
    assert c.metrics.get("app_slo_captures_suppressed_total").value() == 2
    clock.advance(600.0)
    assert w.on_breach(breach) is not None
    assert len(list((tmp_path / "a").glob("slo-capture-*"))) == 2
    w2 = CaptureWatcher(c, slo, out_dir=str(tmp_path / "b"), burst=2, now=clock, clock=clock)
    assert w2.on_breach(breach) and w2.on_breach(breach) and w2.on_breach(breach) is None
    w3 = CaptureWatcher(c, slo, out_dir=str(tmp_path / "c"), now=clock, clock=clock)
    paths = []
    slo.add_breach_listener(lambda br: paths.append(w3.on_breach(br)))
    for _ in range(10):
        slo.observe("interactive", "ttft", 9.0)
    assert len(paths) == 1 and paths[0] is not None
    with open(os.path.join(paths[0], "bundle.json")) as f:
        data = json.load(f)
    assert data["reason"][0]["class"] == "interactive"
    assert data["slo"]["interactive"]["ttft"]["fast"]["total"] == 10
    assert set(data["flight"]) == {"requests", "steps"} and "engines" in data


def test_capture_config_fallback_and_retention(tmp_path):
    """``SLO_CAPTURE_*`` knobs, ``PROFILER_DIR`` when no capture dir is
    set, and the sweep of the oldest bundles past ``SLO_CAPTURE_MAX_BUNDLES``
    (0: none swept), as JAX's (test_quality.py:483)."""
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.metrics.slo import CaptureWatcher

    clock = _Clock()
    w = CaptureWatcher.from_config(DictConfig({"SLO_CAPTURE_DIR": str(tmp_path),
                                               "SLO_CAPTURE_MIN_INTERVAL_S": "30",
                                               "SLO_CAPTURE_BURST": "3"}),
                                   new_mock_container(), _slo(clock), now=clock, clock=clock)
    assert (w.out_dir, w.min_interval_s, w.burst) == (str(tmp_path), 30.0, 3)
    w = CaptureWatcher.from_config(DictConfig({"PROFILER_DIR": str(tmp_path / "prof")}),
                                   new_mock_container(), _slo(clock))
    assert w.out_dir == str(tmp_path / "prof")
    c = new_mock_container({"SLO_CAPTURE": "true", "SLO_CAPTURE_DIR": str(tmp_path / "r"),
                            "SLO_CAPTURE_MAX_BUNDLES": "2"})
    w = c.slo_capture
    assert isinstance(w, CaptureWatcher) and w.max_bundles == 2
    for i in range(5):
        d = tmp_path / "r" / f"slo-capture-20260807-00000{i}-000"
        d.mkdir(parents=True)
        (d / "bundle.json").write_text("{}")
    (tmp_path / "r" / "not-a-capture").mkdir()
    w._sweep()
    left = sorted(p.name for p in (tmp_path / "r").iterdir())
    assert left == ["not-a-capture", "slo-capture-20260807-000003-000",
                    "slo-capture-20260807-000004-000"]
    w.max_bundles = 0
    w._sweep()
    assert sorted(p.name for p in (tmp_path / "r").iterdir()) == left


def test_capture_trace_is_written_into_the_bundle(tmp_path):
    """``SLO_CAPTURE_TRACE_S`` > 0: a Chrome trace lands in the bundle's
    ``trace/`` (on the CPU, CPU activity)."""
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.metrics.slo import CaptureWatcher

    clock = _Clock()
    w = CaptureWatcher(new_mock_container(), _slo(clock), out_dir=str(tmp_path), trace_s=0.1,
                       now=clock, clock=clock)
    path = w.on_breach([{"class": "batch", "objective": "ttft"}])
    w._trace_thread.join(timeout=60)
    with open(os.path.join(path, "trace", "trace.json")) as f:
        assert "traceEvents" in json.load(f)


# -- the App's routes (app.py:681-722, 843-880) --------------------------------------


def test_debug_quality_and_profile_routes(tiny, tmp_path):
    """Outside ``APP_ENV=DEBUG`` both routes are 404. Under it
    ``/debug/quality`` serves the engine's plane (replay payloads trimmed)
    and the quality SLO windows; ``/debug/profile`` writes a trace under
    ``PROFILER_DIR``, answers 409 while one runs and 400 for a bad
    ``seconds``."""
    import httpx

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    base = {"HTTP_PORT": "0", "METRICS_PORT": "0"}
    app = App(config=DictConfig(base), container=new_mock_container(base))
    app.get("/ping", lambda ctx: "pong")  # a route, so the HTTP server runs
    with AppHarness(app) as h:
        for route in ("/debug/quality", "/debug/profile?seconds=0.1"):
            assert httpx.get(h.base + route, timeout=30).status_code == 404
    conf = {**base, "APP_ENV": "DEBUG", "PROFILER_DIR": str(tmp_path),
            "SLO_DEFAULT_QUALITY": "0.99"}
    c = new_mock_container(conf)
    app = App(config=DictConfig(conf), container=c)
    eng = GenerateEngine(tiny[2], device="cpu", slots=2, max_len=64, page_size=8, container=c,
                         quality_shadow_rate=1.0)
    app.serve_model("lm", engine=eng)
    with AppHarness(app) as h:
        eng.generate(PROMPTS[0], max_new_tokens=4, timeout=60)
        assert eng._quality.drain(60)
        q = httpx.get(h.base + "/debug/quality", timeout=30).json()["data"]
        shadow = q["engines"]["lm"]["shadow"]
        assert shadow["samples"] == 1 and shadow["backend"] == "plain"
        assert "prompt" not in shadow["recent"][0] and shadow["recent"][0]["report"]["tokens"] == 4
        assert q["slo"]["default"]["quality"]["fast"]["total"] == 1
        assert httpx.get(h.base + "/debug/profile?seconds=nan", timeout=30).status_code == 400
        replies = {}

        def slow():
            replies["first"] = httpx.get(h.base + "/debug/profile?seconds=1", timeout=60)

        t = threading.Thread(target=slow)
        t.start()
        deadline = time.monotonic() + 10
        while not app._profile_busy.locked() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert httpx.get(h.base + "/debug/profile?seconds=0.1", timeout=30).status_code == 409
        t.join(60)
    data = replies["first"].json()["data"]
    assert data["seconds"] == 1.0 and data["trace_dir"].startswith(str(tmp_path))
    with open(os.path.join(data["trace_dir"], "trace.json")) as f:
        assert "traceEvents" in json.load(f)
