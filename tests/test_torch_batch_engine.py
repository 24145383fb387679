"""The port's ``BatchEngine`` (gofr_tpu_torch/gpu/engine.py) and the embed
and classify branches of its ``build_engine``, held against the JAX
package's (tests/test_engine.py ``TestBatchEngine``, ``TestBuildEngine``,
tests/test_serve_integration.py's ``/embed``) on the CPU.

The port's encoders hold the JAX models' own weights (``params_from_jax``)
and f32; results are held to the JAX functions within 1e-4 (the parity
contract). Batching, bucketing, warmup and config knobs are held exactly.
"""

import threading
import time

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_http_server import AppHarness, _free_port

torch = pytest.importorskip("torch")

TOL = 1e-4


@pytest.fixture(scope="module")
def bert_tiny():
    """(JAX config, JAX params, their numpy tree, the port's Bert)."""
    from gofr_tpu.models import BertConfig, bert as jbert
    from gofr_tpu_torch.models import bert
    from gofr_tpu_torch.models.bert import BertConfig as PortConfig

    cfg = BertConfig.tiny()
    params = jbert.init(cfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return cfg, params, tree, bert.params_from_jax(PortConfig.tiny(), tree, "cpu")


def _want(cfg, params, seq, bucket):
    from gofr_tpu.models import bert as jbert

    return np.asarray(jbert.embed_pooled(cfg, params, jnp.asarray([seq + [0] * (bucket - len(seq))],
                                                                  jnp.int32),
                                         jnp.asarray([len(seq)]))[0])


def _engine(apply, **kw):
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import BatchEngine

    return BatchEngine(apply, new_mock_container(), device="cpu", **kw)


@pytest.mark.quick
def test_embed_batching_matches_single(bert_tiny):
    cfg, params, _, model = bert_tiny
    eng = _engine(model.embed_pooled, max_batch=8, len_buckets=[8, 16])
    try:
        seqs = [list(range(1, 4)), list(range(5, 12)), [9], list(range(20, 32))]
        for s in seqs:
            np.testing.assert_allclose(eng.infer(s, timeout=60),
                                       _want(cfg, params, s, 8 if len(s) <= 8 else 16),
                                       atol=TOL, rtol=TOL)
    finally:
        eng.stop()


def test_concurrent_requests_share_one_batch_padded_to_the_buckets(bert_tiny):
    """Six requests at once within the wait window go out as one step of
    batch bucket 8 and length bucket 8; the two padded rows have length 1;
    every result equals the request served alone (batch invariance)."""
    cfg, params, _, model = bert_tiny
    calls = []

    def apply(tokens, lengths):
        calls.append((tuple(tokens.shape), lengths.tolist()))
        return model.embed_pooled(tokens, lengths)

    eng = _engine(apply, max_batch=16, len_buckets=[8, 16], max_wait_ms=500.0)
    results = [None] * 6
    try:
        eng.infer([1, 2], timeout=60)  # the first step's one-time costs out of the window
        calls.clear()

        def worker(i):
            results[i] = eng.infer([i + 1, i + 2, i + 3][: 1 + i % 3], timeout=60)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        eng.stop()
    assert calls[0][0] == (8, 8) and calls[0][1][6:] == [1, 1], calls
    for i, got in enumerate(results):
        seq = [i + 1, i + 2, i + 3][: 1 + i % 3]
        np.testing.assert_allclose(got, _want(cfg, params, seq, 8), atol=TOL, rtol=TOL)


@pytest.mark.quick
def test_warmup_runs_every_signature_and_serving_adds_none(bert_tiny):
    """Tokens: 2 length buckets x batch buckets {1, 2, 4} = 6 steps, the
    signatures JAX's warmup compiles; a request after it runs a signature
    already warmed. Images: one step a batch bucket."""
    _, _, _, model = bert_tiny
    shapes = []

    def apply(tokens, lengths):
        shapes.append(tuple(tokens.shape))
        assert lengths.tolist() == [1] * tokens.shape[0] or len(shapes) > 6
        return model.embed_pooled(tokens, lengths)

    eng = _engine(apply, max_batch=4, len_buckets=[16, 32])
    try:
        assert eng.warmup([1, 2, 3]) == 6
        assert shapes == [(1, 16), (2, 16), (4, 16), (1, 32), (2, 32), (4, 32)]
        assert eng._compiled == {("batch", lb, nb) for lb in (16, 32) for nb in (1, 2, 4)}
        assert np.asarray(eng.infer([5, 3, 9], timeout=60)).shape == (32,)
        assert ("batch", 16, 1) in eng._compiled and len(eng._compiled) == 6
    finally:
        eng.stop()
    img = _engine(lambda x: x.reshape(x.shape[0], -1)[:, :4], max_batch=8)
    try:
        assert img.warmup(np.zeros((4, 4, 3), np.float32)) == 4
        assert img._compiled == {("batch", (4, 4, 3), nb) for nb in (1, 2, 4, 8)}
    finally:
        img.stop()


@pytest.mark.quick
def test_classify_images_matches_jax():
    from gofr_tpu.models import ViTConfig, vit as jvit
    from gofr_tpu_torch.models import vit
    from gofr_tpu_torch.models.vit import ViTConfig as PortConfig

    cfg = ViTConfig.tiny()
    params = jvit.init(cfg, jax.random.key(0))
    model = vit.params_from_jax(PortConfig.tiny(), jax.tree.map(np.asarray, params), "cpu")
    eng = _engine(model, max_batch=4, encode_fn=lambda x: np.asarray(x, np.float32))
    try:
        img = np.random.RandomState(0).randn(32, 32, 3).astype(np.float32)
        out = eng.infer(img, timeout=60)
        want = np.asarray(jvit.forward(cfg, params, jnp.asarray(img)[None])[0])
        np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
    finally:
        eng.stop()


@pytest.mark.quick
def test_a_step_error_fails_its_batch_only():
    """As JAX: the step's error reaches its caller; the loop goes on, the
    next request is served and health stays UP. A request that does not
    encode fails alone, its batch-mates served."""
    state = {"boom": True}

    def apply(tokens, lengths):
        if state.pop("boom", False):
            raise RuntimeError("boom")
        return tokens.float()

    def encode(x):
        if x == "bad":
            raise ValueError("cannot encode")
        return np.asarray(x)

    eng = _engine(apply, max_batch=4, encode_fn=encode, max_wait_ms=300.0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            eng.infer([1, 2, 3], timeout=60)
        assert eng.infer([4, 5], timeout=60).tolist()[:2] == [4.0, 5.0]
        out = {}

        def one(key, x):
            try:
                out[key] = eng.infer(x, timeout=60)
            except ValueError as e:
                out[key] = e

        threads = [threading.Thread(target=one, args=k) for k in (("bad", "bad"), ("ok", [7]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert isinstance(out["bad"], ValueError) and out["ok"].tolist()[0] == 7.0
        assert eng.health_check()["status"] == "UP"
    finally:
        eng.stop()


@pytest.mark.quick
def test_an_expired_request_fails_with_request_timeout_at_the_drain():
    """A request whose deadline passes while a step runs is failed by the
    next drain with the engine's ``RequestTimeout`` (a 408, and a
    ``TimeoutError``) and never reaches ``apply``."""
    from gofr_tpu_torch.gpu.engine import RequestTimeout

    seen = []

    def apply(tokens, lengths):
        seen.append(tokens[:, 0].tolist())
        time.sleep(0.4)
        return tokens.float()

    eng = _engine(apply, max_batch=2, max_wait_ms=0.0)
    try:
        first = eng._submit([1], None, False, {})
        time.sleep(0.1)
        late = eng._submit([2], 0.05, False, {})
        assert first.result(10).tolist()[0] == 1.0
        assert late._done.wait(10)
        _, error = late.outcome()
        assert isinstance(error, RequestTimeout) and isinstance(error, TimeoutError)
        assert seen == [[1]]
    finally:
        eng.stop()


def _jax_engine(spec_kw, conf, **kw):
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import BertConfig, ModelSpec
    from gofr_tpu.tpu.engine import build_engine

    spec = ModelSpec("bert", BertConfig.tiny(), task="embed", dtype=jnp.float32, **spec_kw)
    return build_engine(spec, new_mock_container(conf), **kw)


def _port_engine(family, conf, weights=None, **kw):
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import BertConfig, ModelSpec, ViTConfig

    cfg, task = (BertConfig.tiny(), "embed") if family == "bert" else (ViTConfig.tiny(), "classify")
    c = new_mock_container(conf)
    spec = ModelSpec(family, cfg, task=task, weights=weights, dtype=torch.float32)
    return build_engine(spec, c, device="cpu", **kw), c


@pytest.mark.quick
@pytest.mark.parametrize("conf,kw", [
    ({}, {}),
    ({"ENGINE_MAX_BATCH": "8", "ENGINE_MAX_WAIT_MS": "5"}, {}),
    ({"ENGINE_MAX_BATCH": "8", "ENGINE_MAX_WAIT_MS": "5"}, {"max_batch": 2, "max_wait_ms": 0.5}),
])
def test_build_embed_engine_reads_the_knobs_as_jax_does(bert_tiny, conf, kw):
    """``ENGINE_MAX_BATCH`` (32) and ``ENGINE_MAX_WAIT_MS`` (2.0) from the
    config, ``kw`` winning: the port's engine has the JAX engine's batch,
    window and buckets, and on the JAX weights its embedding."""
    from gofr_tpu_torch.gpu.engine import BatchEngine

    cfg, params, tree, _ = bert_tiny
    jeng = _jax_engine({}, conf, **kw)
    jeng.stop()
    eng, c = _port_engine("bert", conf, tree, **kw)
    try:
        assert isinstance(eng, BatchEngine)
        assert (eng.max_batch, eng.max_wait, eng.batch_buckets, eng.len_buckets) == (
            jeng.max_batch, jeng.max_wait, jeng.batch_buckets, jeng.len_buckets)
        emb = eng.infer([4, 5, 6], timeout=60)
        assert emb.shape == (32,)
        np.testing.assert_allclose(emb, _want(cfg, params, [4, 5, 6], 16), atol=TOL, rtol=TOL)
    finally:
        eng.stop()


@pytest.mark.quick
def test_build_classify_engine_and_random_weights_are_announced():
    from gofr_tpu_torch.gpu.engine import BatchEngine

    eng, c = _port_engine("vit", {"ENGINE_MAX_BATCH": "4"})
    try:
        assert isinstance(eng, BatchEngine) and eng.max_batch == 4
        out = eng.infer(np.zeros((32, 32, 3), np.float32), timeout=60)
        assert out.shape == (10,) and np.isfinite(out).all()
    finally:
        eng.stop()
    assert any(r["level"] == "WARN" and "randomly initialized" in r["message"]
               for r in c.logger.records)


@pytest.mark.quick
def test_strings_need_the_spec_s_tokenizer_as_in_jax(bert_tiny):
    from gofr_tpu_torch.utils.tokenizer import ByteTokenizer

    _, _, tree, _ = bert_tiny
    eng, _ = _port_engine("bert", {}, tree)
    try:
        with pytest.raises(ValueError, match="string input but no tokenizer"):
            eng.infer("hello", timeout=60)
        with pytest.raises(ValueError, match="token id outside"):
            eng.infer([1, 999], timeout=60)
    finally:
        eng.stop()
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import BertConfig, ModelSpec

    tok = ByteTokenizer()
    spec = ModelSpec("bert", BertConfig.tiny(vocab_size=300), task="embed", tokenizer=tok,
                     dtype=torch.float32)
    eng = build_engine(spec, new_mock_container(), device="cpu")
    try:
        np.testing.assert_array_equal(eng.infer("hi tpu", timeout=60),
                                      eng.infer(tok.encode("hi tpu"), timeout=60))
    finally:
        eng.stop()


@pytest.mark.quick
@pytest.mark.parametrize("family,task,match", [
    ("bert", "nonsense", "unknown task"),
    ("bert", "generate", "serves embed"),
    ("llama", "embed", "serves generate"),
    ("vit", "embed", "serves classify"),
])
def test_a_task_the_family_does_not_serve_is_refused(family, task, match):
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import ModelSpec, get_family

    spec = ModelSpec(family, get_family(family).CONFIG.tiny(), task=task)
    with pytest.raises(ValueError, match=match):
        build_engine(spec, new_mock_container(), device="cpu")


@pytest.mark.quick
@pytest.mark.parametrize("family", ["bert", "vit"])
def test_an_f32_encoder_on_the_card_is_refused(monkeypatch, family):
    """Kernel C is built for bf16 and f32: an encoder in another dtype
    (fp16) on the card raises at build time, before any weight is drawn;
    f32, the encoders' own default, and bf16 pass that check."""
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu import engine
    from gofr_tpu_torch.models import ModelSpec, get_family

    monkeypatch.setattr(engine, "resolve_device", lambda device=None: torch.device("cuda"))

    def no_weights(*a, **kw):
        raise AssertionError("weights drawn")

    monkeypatch.setattr(engine, "_model", no_weights)
    task = "embed" if family == "bert" else "classify"
    spec = ModelSpec(family, get_family(family).CONFIG.tiny(), task=task, dtype=torch.float16)
    with pytest.raises(ValueError, match="kernel C takes bf16 or f32 only"):
        engine.build_engine(spec, new_mock_container())
    for dtype in (torch.float32, torch.bfloat16):
        spec.dtype = dtype
        with pytest.raises(AssertionError, match="weights drawn"):
            engine.build_engine(spec, new_mock_container())


@pytest.mark.quick
def test_embed_over_http_as_the_jax_test_serves_it(bert_tiny):
    """tests/test_serve_integration.py's ``/embed`` on the port's App: 201,
    dimension 32, unit norm, the JAX embedding; the step histogram on the
    metrics port; the engine in health."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.models import BertConfig, ModelSpec

    cfg, params, tree, _ = bert_tiny
    conf = {"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port())}
    app = App(config=DictConfig(conf), container=new_mock_container(conf))
    app.serve_model("embedder", ModelSpec("bert", BertConfig.tiny(), task="embed", weights=tree,
                                          dtype=torch.float32), device="cpu")

    def embed(ctx):
        vec = ctx.infer("embedder", ctx.bind(dict)["tokens"], timeout=120)
        return {"embedding": [float(x) for x in vec], "dim": len(vec)}

    app.post("/embed", embed)
    with AppHarness(app) as h, httpx.Client(base_url=h.base, timeout=180) as client:
        r = client.post("/embed", json={"tokens": [4, 9, 2]})
        assert r.status_code == 201, r.text
        data = r.json()["data"]
        assert data["dim"] == 32
        assert abs(sum(x * x for x in data["embedding"]) ** 0.5 - 1.0) < 1e-4
        np.testing.assert_allclose(data["embedding"], _want(cfg, params, [4, 9, 2], 16),
                                   atol=TOL, rtol=TOL)
        health = client.get("/.well-known/health").json()["data"]
        assert health["services"]["model:embedder"]["status"] == "UP"
        m = httpx.get(f"http://127.0.0.1:{app.metrics_port}/metrics").text
        assert 'app_tpu_step_seconds_count{kind="batch"} 1' in m
        assert "app_tpu_tokens_total 1" in m


@pytest.mark.quick
def test_grpc_and_pubsub_serve_embed_and_classify_through_the_context():
    """A JSON-over-gRPC handler (``current_grpc_context().infer``) and a
    pub/sub subscriber (``ctx.infer``) reach the batch engines with no
    transport code of their own: each request answers, and every message
    is handled and committed."""
    grpc = pytest.importorskip("grpc")
    import json

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.grpc.server import current_grpc_context
    from gofr_tpu_torch.models import BertConfig, ModelSpec, ViTConfig

    conf = {"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port()), "GRPC_PORT": "0",
            "ENGINE_MAX_BATCH": "4"}
    app = App(config=DictConfig(conf), container=new_mock_container(conf))
    app.serve_model("bert", ModelSpec("bert", BertConfig.tiny(), task="embed",
                                      dtype=torch.float32), device="cpu")
    app.serve_model("vit", ModelSpec("vit", ViTConfig.tiny(), task="classify",
                                     dtype=torch.float32), device="cpu")

    def embed(request, context):
        return {"embedding": current_grpc_context().infer("bert", request["tokens"]).tolist()}

    def add(server):
        codec = dict(request_deserializer=lambda b: json.loads(b.decode()),
                     response_serializer=lambda o: json.dumps(o).encode())
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler("embed.Embed", {
            "Embed": grpc.unary_unary_rpc_method_handler(embed, **codec)}),))

    classes, lock = {}, threading.Lock()

    def on_image(ctx):
        body = ctx.bind(dict)
        logits = ctx.infer("vit", np.asarray(body["image"], np.float32))
        with lock:
            classes[body["i"]] = int(np.argmax(logits))

    app.register_grpc_service(add)
    app.subscribe("images", on_image)
    rng = np.random.default_rng(8)
    with AppHarness(app):
        with grpc.insecure_channel(f"127.0.0.1:{app.grpc_port}") as ch:
            call = ch.unary_unary("/embed.Embed/Embed",
                                  request_serializer=lambda o: json.dumps(o).encode(),
                                  response_deserializer=lambda b: json.loads(b.decode()))
            replies = [call({"tokens": [i + 1, 2, 3]}, timeout=60) for i in range(3)]
        for i in range(4):
            app.container.publish("images", {"i": i, "image": rng.standard_normal(
                (32, 32, 3)).astype(np.float32).tolist()})
        deadline = time.monotonic() + 60
        while len(classes) < 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        m = app.container.metrics
        counts = {name: m.get(name).value(topic="images")
                  for name in ("app_pubsub_subscribe_total_count",
                               "app_pubsub_subscribe_success_count")}
    assert all(abs(np.linalg.norm(r["embedding"]) - 1) < 1e-4 for r in replies)
    assert sorted(classes) == [0, 1, 2, 3]
    assert counts == {"app_pubsub_subscribe_total_count": 4,
                      "app_pubsub_subscribe_success_count": 4}
