"""The port's App serving ``/generate`` (examples/serving-llm-torch) held
against the JAX App serving the JAX example (examples/serving-llm), and
the port's ``build_engine(spec, container)`` against the JAX one on the
same ``ENGINE_*`` / ``ADAPTER_*`` config.

Tolerances: exact. Both examples serve the tiny f32 Llama (vocabulary 300,
the byte tokenizer), the port's on the JAX engine's own weights
(``params_from_jax``): greedy tokens, text and ``finish_reason`` are
equal for every request, SSE frames equal frame for frame, and status
codes and error envelopes equal request for request. Each ``ENGINE_*``
set builds engines with the same knobs whose greedy tokens are equal.
Both Apps run under tests/test_http_server.py's ``AppHarness``; the JAX
App is compiled once per module.
"""

import importlib.util
import json
import os
import threading
import time

import httpx
import jax
import numpy as np
import pytest

from tests.test_http_server import AppHarness, _free_port

torch = pytest.importorskip("torch")

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
N_NEW = 6


def _load(name: str):
    path = os.path.join(EXAMPLES, name, "main.py")
    spec = importlib.util.spec_from_file_location(f"example_{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ports() -> dict:
    return {"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port())}


@pytest.fixture(scope="module")
def apps():
    """The JAX example and the port's, running, the port's on the JAX
    engine's weights: (JAX base URL, port base URL, the port App)."""
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu_torch.config import DictConfig

    japp = _load("serving-llm").build_app(JaxConfig(_ports()))
    params = jax.tree.map(np.asarray, japp.container.engines["lm"].params)
    papp = _load("serving-llm-torch").build_app(DictConfig(_ports()), params=params, device="cpu")
    with AppHarness(japp) as jh, AppHarness(papp) as ph:
        yield jh.base, ph.base, papp


def _post(base: str, body: dict, **kw) -> httpx.Response:
    return httpx.post(f"{base}/generate", json=body, timeout=300, **kw)


def _same(got: dict, want: dict) -> None:
    for key in ("tokens", "text", "finish_reason"):
        assert got[key] == want[key], key


PROMPTS = {
    "ids": [[1, 2, 3]],
    "string": ["hello tpu"],
    "string_ids": [[ord(c) + 3 for c in "hello tpu"]],
    "concurrent": [[7, 8, 9, 10], "two at once"],
}


@pytest.mark.quick
@pytest.mark.parametrize("case", list(PROMPTS))
def test_generate_equals_the_jax_app(apps, case):
    """An id prompt, a string prompt, the string's ids (which must give the
    string's tokens) and two requests at once: 201 with equal tokens, text
    and finish reason from both Apps."""
    jbase, pbase, _ = apps
    out = {}
    for base in (jbase, pbase):
        got = [None] * len(PROMPTS[case])

        def one(i, prompt, base=base, got=got):
            got[i] = _post(base, {"prompt": prompt, "max_new_tokens": N_NEW})

        threads = [threading.Thread(target=one, args=(i, p)) for i, p in enumerate(PROMPTS[case])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert all(r.status_code == 201 for r in got), [r.text for r in got]
        out[base] = [r.json()["data"] for r in got]
    for got, want in zip(out[pbase], out[jbase]):
        _same(got, want)
        assert len(got["tokens"]) == N_NEW and got["finish_reason"] == "length"
    if case == "string_ids":
        assert out[pbase][0]["tokens"] == _post(pbase, {"prompt": "hello tpu", "max_new_tokens": N_NEW}
                                                ).json()["data"]["tokens"]


def _sse(base: str, body: dict) -> list[tuple[str, object]]:
    frames, event = [], None
    with httpx.stream("POST", f"{base}/generate/stream", json=body, timeout=300) as r:
        assert r.status_code == 200
        assert r.headers["content-type"].startswith("text/event-stream")
        assert "content-length" not in r.headers
        for line in r.iter_lines():
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                frames.append((event, json.loads(line[len("data: "):])))
    return frames


@pytest.mark.quick
def test_sse_frames_equal_the_jax_app(apps):
    """``/generate/stream``: the same event names and data frame for frame,
    ending in ``done``, and the pieces join to the unary text."""
    jbase, pbase, _ = apps
    body = {"prompt": "stream me", "max_new_tokens": N_NEW}
    want, got = _sse(jbase, body), _sse(pbase, body)
    assert got == want
    assert got[-1] == ("done", {}) and all(e == "token" for e, _ in got[:-1])
    text = _post(pbase, body).json()["data"]["text"]
    assert "".join(d for _, d in got[:-1]) == text


CASES = {
    "unregistered_route": ("GET", "/nope", {}),
    "body_not_json": ("POST", "/generate", {"content": b"{nope"}),
    "prompt_missing": ("POST", "/generate", {"json": {"max_new_tokens": 2}}),
    "timeout": ("POST", "/generate", {"json": {"prompt": [1, 2], "timeout": 0.001}}),
    "adapter_header_without_plane": ("POST", "/generate", {"json": {"prompt": [1, 2]},
                                                           "headers": {"X-Adapter-ID": "fr"}}),
    "health": ("GET", "/.well-known/health", {}),
    "alive": ("GET", "/.well-known/alive", {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_status_and_envelope_equal_the_jax_app(apps, case):
    """Status code and error message (or, for health, the overall and the
    model's status) equal the JAX App's."""
    jbase, pbase, _ = apps
    method, path, kw = CASES[case]
    out = []
    for base in (jbase, pbase):
        r = httpx.request(method, f"{base}{path}", timeout=300, **kw)
        body = r.json()
        if case == "health":
            body = (body["data"]["status"], body["data"]["services"]["model:lm"]["status"])
        out.append((r.status_code, body))
    assert out[1] == out[0]


def test_a_dropped_sse_client_frees_its_slot(apps, monkeypatch):
    """The client drops the stream after its first token: the server
    cancels the request (it ends cancelled, not at its length) and the
    engine's slot is free again within 30 s (cf. tests/test_examples.py:102).
    Each decode dispatch is slowed, so the 50 tokens outlast the
    disconnect."""
    from gofr_tpu_torch.gpu import decode
    from gofr_tpu_torch.gpu.engine import RequestCancelled

    _, pbase, papp = apps
    engine = papp.container.engines["lm"]
    submitted, submit, plain_dispatch = [], engine.submit, decode.dispatch_decode

    def slow_dispatch(eng):
        time.sleep(0.1)
        return plain_dispatch(eng)

    monkeypatch.setattr(engine, "submit", lambda *a, **kw: submitted.append(submit(*a, **kw))
                        or submitted[-1])
    monkeypatch.setattr(decode, "dispatch_decode", slow_dispatch)
    with httpx.stream("POST", f"{pbase}/generate/stream",
                      json={"prompt": [1, 2, 3], "max_new_tokens": 50, "timeout": 300},
                      timeout=300) as r:
        assert r.status_code == 200
        for line in r.iter_lines():
            if line.startswith("data: "):
                break
    deadline = time.time() + 30
    while time.time() < deadline:
        if all(s is None for s in engine.slots) and not engine._pending:
            break
        time.sleep(0.05)
    assert all(s is None for s in engine.slots), "slot still held after the client went away"
    (req,) = submitted
    assert req.cancel_reason == "client_disconnect"
    assert isinstance(req.outcome()[1], RequestCancelled)


def _port_lm(config: dict | None = None, **kw):
    """A port App (mock container) serving the tiny model on the CPU."""
    from gofr_tpu_torch.app import new_testing
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.utils.tokenizer import ByteTokenizer

    app = new_testing({**_ports(), **(config or {})})
    spec = ModelSpec("llama", LlamaConfig.tiny(vocab_size=300), dtype=torch.float32,
                     tokenizer=ByteTokenizer())
    engine = app.serve_model("lm", spec, device="cpu", **{"slots": 4, "max_len": 64,
                                                          "eos_token_id": -1, **kw})
    return app, engine


def test_adapter_header_and_body_route_as_the_engine_does():
    """A handler that passes ``body.get("adapter_id")`` on, as
    examples/using-adapters does: the ``X-Adapter-ID`` header and the body
    field give the tokens of the engine's own ``generate`` with that
    adapter."""
    from gofr_tpu_torch.adapters import random_adapter
    from gofr_tpu_torch.http.errors import InvalidParam

    app, engine = _port_lm(adapter_slots=3, adapter_rank=8)
    engine.register_adapter(random_adapter("fr", 64, 300, rank=4, seed=1))

    async def generate(ctx):
        body = ctx.bind(dict)
        kw = {"adapter_id": body["adapter_id"]} if body.get("adapter_id") else {}
        try:
            return await ctx.agenerate("lm", body["prompt"], max_new_tokens=N_NEW, **kw)
        except ValueError as e:
            raise InvalidParam("adapter_id") from e

    app.post("/generate", generate)
    prompt = [4, 5, 6, 7]
    with AppHarness(app) as h:
        by_header = _post(h.base, {"prompt": prompt}, headers={"X-Adapter-ID": "fr"})
        by_body = _post(h.base, {"prompt": prompt, "adapter_id": "fr"})
        unknown = _post(h.base, {"prompt": prompt, "adapter_id": "nope"})
        want = engine.generate(prompt, max_new_tokens=N_NEW, adapter_id="fr", timeout=300)
    assert by_header.status_code == by_body.status_code == 201
    assert by_header.json()["data"]["tokens"] == by_body.json()["data"]["tokens"] == want["tokens"]
    assert unknown.status_code == 400
    assert unknown.json() == {"error": {"message": "'1' invalid parameter(s): adapter_id"}}


def test_health_reads_down_after_the_engine_died():
    """An engine whose loop died with an error reads DOWN, and the health
    route answers 503; after ``stop`` the engine's thread has ended."""
    app, engine = _port_lm()
    app.post("/generate", lambda ctx: ctx.generate("lm", ctx.bind(dict)["prompt"], max_new_tokens=2))

    def die():
        raise RuntimeError("device fault")

    with AppHarness(app) as h:
        assert httpx.get(f"{h.base}/.well-known/health", timeout=30).json()["data"]["status"] == "UP"
        engine._admit = die
        r = _post(h.base, {"prompt": [1, 2, 3]})
        assert r.status_code == 500
        r = httpx.get(f"{h.base}/.well-known/health", timeout=30)
        assert r.status_code == 503
        assert r.json()["data"]["services"]["model:lm"] == {
            "status": "DOWN", "details": {"error": "device fault"}}
    assert not engine._thread.is_alive()


# -- build_engine(spec, container) against the JAX build_engine ------------------------

ENVS = {
    "defaults": {},
    "kv_int8": {"ENGINE_KV_DTYPE": "int8"},
    "kv_int4": {"ENGINE_KV_DTYPE": "int4"},
    "kv_quantize_alias": {"ENGINE_KV_QUANTIZE": "int8"},
    "slot": {"ENGINE_KV_LAYOUT": "slot"},
    "small_pool": {"ENGINE_SLOTS": "2", "ENGINE_MAX_LEN": "48", "ENGINE_PAGE_SIZE": "16",
                   "ENGINE_TOTAL_PAGES": "9"},
    "spec": {"ENGINE_SPEC_TOKENS": "2"},
    "no_prefix_cache": {"ENGINE_PREFIX_CACHE": "false"},
    "adapter_slots_1": {"ADAPTER_SLOTS": "1"},
    "adapter_pool_rank_0": {"ADAPTER_POOL_MB": "0.25", "ADAPTER_RANK": "0"},
    "timeout": {"ENGINE_TIMEOUT": "5"},
    "pipeline_3_host_tier": {"ENGINE_PIPELINE": "3", "ENGINE_PREFIX_HOST_MB": "16"},
    "pipeline_alias_1": {"ENGINE_DECODE_PIPELINE": "1"},
}


def _knobs(eng) -> dict:
    paged = eng.kv_layout == "paged"
    pool = eng.adapter_stats().get("pool")
    return {"slots": eng.num_slots, "max_len": eng.max_len, "layout": eng.kv_layout,
            "kv_quantize": eng.kv_quantize, "page_size": eng.page_size if paged else None,
            "total_pages": eng.total_pages if paged else None, "spec_tokens": eng.spec_tokens,
            "prefix_cache": eng._prefix is not None if paged else None,
            "adapters": (pool["slots"], pool["rank"]) if pool else None,
            "default_timeout": eng.default_timeout, "pipeline_depth": eng.pipeline_depth,
            "prefix_host_budget": eng._prefix.host_budget if paged and eng._prefix else None}


def _jax_engine(env: dict):
    import jax.numpy as jnp
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import LlamaConfig, ModelSpec
    from gofr_tpu.tpu.engine import build_engine

    spec = ModelSpec("llama", LlamaConfig.tiny(vocab_size=300), dtype=jnp.float32)
    return build_engine(spec, new_mock_container(env), seed=3)


def _port_engine(env: dict, params, **kw):
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.models.llama import LlamaConfig

    container = new_mock_container(env)
    spec = ModelSpec("llama", LlamaConfig.tiny(vocab_size=300), weights=params, dtype=torch.float32)
    return build_engine(spec, container, device="cpu", **kw), container


@pytest.mark.parametrize("env", list(ENVS))
def test_config_builds_the_jax_engine_s_knobs_and_tokens(env):
    """Each env set: the same slots, max_len, layout, KV format, page size,
    pages, prefix cache, spec tokens, adapter pool slots and rank, default
    timeout, pipeline depth and host-tier budget as the JAX ``build_engine``, and the same greedy
    tokens for one prompt (the port on the JAX engine's weights)."""
    prompt = [5, 3, 9, 17, 2]
    jeng = _jax_engine(ENVS[env])
    try:
        want_knobs = _knobs(jeng)
        want = jeng.generate(prompt, max_new_tokens=N_NEW, timeout=300)["tokens"]
        params = jax.tree.map(np.asarray, jeng.params)
    finally:
        jeng.stop()
    eng, _ = _port_engine(ENVS[env], params)
    try:
        assert _knobs(eng) == want_knobs
        assert eng.generate(prompt, max_new_tokens=N_NEW, timeout=300)["tokens"] == want
    finally:
        eng.stop()


@pytest.mark.quick
@pytest.mark.parametrize("env,item", [
    ({"ENGINE_QUANTIZE": "int8"}, "Queue A 3"),
    ({"ENGINE_ROLE": "prefill"}, "Queue A 6"),
    ({"ADAPTER_HOTSWAP_DIR": "/nowhere"}, "Queue A 9"),
])
def test_a_knob_that_changes_what_is_served_is_refused(env, item):
    with pytest.raises(ValueError, match=item):
        _port_engine(env, None)


@pytest.mark.quick
@pytest.mark.parametrize("env,depth,host_mb", [
    ({"ENGINE_PIPELINE": "3"}, 3, 0.0),
    ({"ENGINE_DECODE_PIPELINE": "1"}, 1, 0.0),
    ({"ENGINE_PIPELINE": "4", "ENGINE_DECODE_PIPELINE": "1"}, 4, 0.0),
    ({"ENGINE_PIPELINE": "9"}, 4, 0.0),
    ({"ENGINE_PREFIX_HOST_MB": "64"}, 2, 64.0),
    ({}, 2, 0.0),
])
def test_the_pipeline_and_host_tier_knobs_are_honoured(env, depth, host_mb):
    """``ENGINE_PIPELINE`` (canonical), ``ENGINE_DECODE_PIPELINE`` (its
    alias) and ``ENGINE_PREFIX_HOST_MB`` reach the engine as the JAX
    ``build_engine`` reads them (depth clamped to 1..4, default 2; the host
    tier's budget in MiB), the engine serves, and nothing is logged about
    them."""
    eng, container = _port_engine(env, None, max_len=32, slots=2, page_size=8)
    try:
        assert eng.pipeline_depth == depth
        assert eng._prefix.host_budget == int(host_mb * (1 << 20))
        assert eng.generate([1, 2, 3], max_new_tokens=2, timeout=300)["finish_reason"] == "length"
    finally:
        eng.stop()
    assert not [r for r in container.logger.records if r["level"] == "WARN"
                and ("PIPELINE" in r["message"] or "HOST_MB" in r["message"])]


@pytest.mark.quick
def test_keywords_win_over_config_and_eos_comes_from_the_tokenizer():
    from gofr_tpu_torch.utils.tokenizer import ByteTokenizer

    env = {"ENGINE_SLOTS": "2", "ENGINE_KV_DTYPE": "int8", "ENGINE_TIMEOUT": "7"}
    eng, _ = _port_engine(env, None, slots=3, kv_quantize="", max_len=32)
    try:
        assert (eng.num_slots, eng.kv_quantize, eng.default_timeout, eng.eos_token_id) == (
            3, "", 7.0, None)
    finally:
        eng.stop()
    app, eng = _port_lm({"ENGINE_SLOTS": "2"}, eos_token_id=None)
    try:
        assert eng.num_slots == 4 and eng.eos_token_id == ByteTokenizer.eos_token_id
    finally:
        eng.stop()
