"""The slice as a whole on the CPU: a gateway App in front of a model App,
in each package. The model App migrates its schema at boot (a
``completion`` table, then a column added), gives the table its CRUD
routes, and answers ``POST /complete`` by generating on the served tiny
Llama, storing the tokens in SQLite and a key in the KV store; the
gateway serves no model and reaches the model App through
``register_service`` (circuit breaker, retry, retry budget) as
``ctx.http_service("model")``. The port's pair runs on the JAX pair's
weights (the JAX engine's parameters as numpy arrays).

Tolerances: exact. Greedy f32 tokens through the gateway, and the rows
read back through CRUD, equal the JAX pair's; both model Apps' health and
both gateways' list the same keys with the same statuses; a call through
the gateway carries its trace id and the caller's deadline to the model
App in both; with the model App stopped, both gateways answer 503 and
open their breakers after the same number of calls.
"""

import json
import threading
import time
from types import SimpleNamespace

import httpx
import jax
import numpy as np
import pytest

from tests.test_http_server import AppHarness, _free_port

torch = pytest.importorskip("torch")

N_NEW = 6
PROMPTS = [[5, 6, 7, 8], [9, 10, 11], [12, 13, 14, 15, 16]]
THRESHOLD, RETRIES = 3, 1
MIGRATIONS_SQL = (
    "CREATE TABLE completion (id INTEGER PRIMARY KEY, prompt TEXT, tokens TEXT, ttft_s REAL)",
    "ALTER TABLE completion ADD COLUMN decode_s REAL",
)


def _packages():
    """The names each pair is built from, in each package."""
    import gofr_tpu.app as japp
    import gofr_tpu.config as jconf
    import gofr_tpu.deadline as jdl
    import gofr_tpu.models as jmodels
    import gofr_tpu.service as jsvc
    import gofr_tpu.service.budget as jbudget
    import jax.numpy as jnp

    import gofr_tpu_torch.app as papp
    import gofr_tpu_torch.config as pconf
    import gofr_tpu_torch.deadline as pdl
    import gofr_tpu_torch.models as pmodels
    import gofr_tpu_torch.service as psvc
    import gofr_tpu_torch.service.budget as pbudget
    from gofr_tpu_torch.models.llama import LlamaConfig

    return {
        "jax": SimpleNamespace(App=japp.App, Config=jconf.DictConfig, deadline=jdl, svc=jsvc,
                               RetryBudget=jbudget.RetryBudget, ModelSpec=jmodels.ModelSpec,
                               LlamaConfig=jmodels.LlamaConfig, dtype=jnp.float32),
        "port": SimpleNamespace(App=papp.App, Config=pconf.DictConfig, deadline=pdl, svc=psvc,
                                RetryBudget=pbudget.RetryBudget, ModelSpec=pmodels.ModelSpec,
                                LlamaConfig=LlamaConfig, dtype=torch.float32),
    }


def completion_entity():
    import dataclasses

    @dataclasses.dataclass
    class Completion:
        id: int
        prompt: str
        tokens: str
        ttft_s: float
        decode_s: float

    return Completion


def model_app(pkg, name: str, tmp, weights=None):
    """The model App: migrations 1 and 2 at boot, CRUD over ``completion``,
    ``POST /complete`` generating and storing, ``GET /device`` reading
    ``ctx.tpu``. ``seen`` collects what each call brought in."""
    app = pkg.App(config=pkg.Config({
        "HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port()),
        "DB_DIALECT": "sqlite", "DB_NAME": str(tmp / f"{name}.db"),
        "KV_PATH": str(tmp / f"{name}.kv"), "TRACE_EXPORTER": "memory", "LOG_LEVEL": "ERROR"}))
    app.migrate({v + 1: (lambda d, q=q: d.sql.execute(q)) for v, q in enumerate(MIGRATIONS_SQL)})
    app.add_rest_handlers(completion_entity())
    spec = pkg.ModelSpec("llama", pkg.LlamaConfig.tiny(vocab_size=300), task="generate",
                         dtype=pkg.dtype, **({} if weights is None else {"weights": weights}))
    app.serve_model("lm", spec, slots=4, max_len=64, eos_token_id=-1,
                    **({"device": "cpu"} if name == "port" else {}))
    seen = {}

    async def complete(ctx):
        body = ctx.bind(dict)
        seen[body["id"]] = {"trace_id": ctx.span.trace_id, "deadline_s": ctx.deadline_remaining(),
                            "traceparent": ctx.header("traceparent")}
        o = await ctx.agenerate("lm", body["prompt"], max_new_tokens=N_NEW, timeout=120)
        ctx.sql.execute("INSERT INTO completion (id, prompt, tokens, ttft_s, decode_s) "
                        "VALUES (?, ?, ?, ?, ?)", (body["id"], json.dumps(body["prompt"]),
                                                   json.dumps(o["tokens"]), o["ttft_s"],
                                                   o.get("decode_s")))
        ctx.kv.set(f"completion:{body['id']}", json.dumps(o["tokens"]))
        return {"id": body["id"], "tokens": o["tokens"]}

    def device(ctx):
        return ctx.tpu.health_check()["details"]["platform"]

    app.post("/complete", complete)
    app.get("/device", device)
    return app, seen


def gateway_app(pkg, model_url: str):
    """The gateway: no model; ``POST /ask`` and ``GET /completion/{id}``
    forward to the model App under a span of their own, the caller's
    remaining deadline stamped on the way out."""
    app = pkg.App(config=pkg.Config({
        "HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port()),
        "TRACE_EXPORTER": "memory", "LOG_LEVEL": "ERROR"}))
    budget = pkg.RetryBudget(fraction=0.2, min_retries=3, window_s=10.0,
                             metrics=app.container.metrics)
    app.register_service("model", model_url,
                         pkg.svc.CircuitBreaker(threshold=THRESHOLD, interval=30.0),
                         pkg.svc.Retry(max_retries=RETRIES, backoff=0.01, budget=budget))
    seen = {}

    def forward(ctx, method, path, body=None):
        headers = {"Content-Type": "application/json"}
        rem = ctx.deadline_remaining()
        if rem is not None:
            headers[pkg.deadline.DEADLINE_HEADER] = pkg.deadline.header_value(
                time.monotonic() + rem)
        with ctx.trace(f"forward {path}"):
            resp = ctx.http_service("model").request(method, path, body=body, headers=headers)
        return resp.json()["data"]

    def ask(ctx):
        body = ctx.bind(dict)
        seen[body["id"]] = ctx.span.trace_id
        return forward(ctx, "POST", "/complete", json.dumps(body).encode())

    def read(ctx):
        return forward(ctx, "GET", f"/completion/{ctx.path_param('id')}")

    app.post("/ask", ask)
    app.get("/completion/{id}", read)
    return app, seen


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Both pairs running: per package the model App, its harness, the
    gateway and what each handler saw."""
    tmp = tmp_path_factory.mktemp("app_services")
    pk = _packages()
    out, harnesses = {}, []
    for name in ("jax", "port"):
        weights = None if name == "jax" else jax.tree.map(
            np.asarray, out["jax"].model.container.engines["lm"].params)
        model, model_seen = model_app(pk[name], name, tmp, weights)
        mh = AppHarness(model).__enter__()
        harnesses.append(mh)
        gateway, gw_seen = gateway_app(pk[name], mh.base)
        gh = AppHarness(gateway).__enter__()
        harnesses.append(gh)
        out[name] = SimpleNamespace(model=model, model_h=mh, model_seen=model_seen,
                                    gateway=gateway, gateway_h=gh, gateway_seen=gw_seen,
                                    pkg=pk[name])
    yield out
    for h in reversed(harnesses):
        if h._thread.is_alive():
            h.__exit__(None, None, None)


def _ask_all(base: str, budget_s: float = 120.0) -> list[dict]:
    """The prompts as concurrent ``POST /ask``, each with a deadline."""
    got = [None] * len(PROMPTS)

    def one(i):
        deadline_ms = str(int((time.time() + budget_s) * 1000))
        got[i] = httpx.post(f"{base}/ask", json={"id": i + 1, "prompt": PROMPTS[i]}, timeout=120,
                            headers={"X-Request-Deadline-Ms": deadline_ms})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert all(r is not None and r.status_code == 201 for r in got), [r and r.text for r in got]
    return [r.json()["data"] for r in got]


@pytest.mark.quick
def test_tokens_stored_and_read_back_equal_the_jax_pair(pairs):
    """``bf16``'s rule at tiny size in f32: every request's tokens through
    the gateway equal the JAX pair's, and each row read back through the
    gateway's CRUD forward holds those tokens; the schema carries both
    migrations; the KV store holds each completion."""
    out = {name: _ask_all(p.gateway_h.base) for name, p in pairs.items()}
    assert [o["tokens"] for o in out["port"]] == [o["tokens"] for o in out["jax"]]
    assert all(len(o["tokens"]) == N_NEW for o in out["port"])
    rows = {}
    for name, p in pairs.items():
        rows[name] = []
        for i, o in enumerate(out[name]):
            r = httpx.get(f"{p.gateway_h.base}/completion/{i + 1}", timeout=60)
            assert r.status_code == 200, r.text
            row = r.json()["data"]
            assert json.loads(row["tokens"]) == o["tokens"]
            assert json.loads(row["prompt"]) == PROMPTS[i]
            assert row["ttft_s"] > 0
            rows[name].append((row["id"], row["prompt"], row["tokens"]))
        sql, kv = p.model.container.sql, p.model.container.kv
        assert [r["version"] for r in sql.query(
            "SELECT version FROM gofr_migrations ORDER BY version")] == [1, 2]
        assert [r["name"] for r in sql.query("PRAGMA table_info(completion)")] == [
            "id", "prompt", "tokens", "ttft_s", "decode_s"]
        assert json.loads(kv.get("completion:1")) == out[name][0]["tokens"]
    assert rows["port"] == rows["jax"]


def test_health_lists_the_jax_pair_s_keys(pairs):
    """The model Apps list sql, kv, file, tpu, slo and ``model:lm``; the
    gateways ``service:model`` besides file and slo: the same keys and
    statuses in both packages, and ``ctx.tpu`` reads the CPU in both."""
    health = {}
    for name, p in pairs.items():
        health[name] = {}
        for side, h in (("model", p.model_h), ("gateway", p.gateway_h)):
            r = httpx.get(f"{h.base}/.well-known/health", timeout=60)
            data = r.json()["data"]
            health[name][side] = (r.status_code, data["status"],
                                  {k: v["status"] for k, v in data["services"].items()})
        assert httpx.get(f"{p.model_h.base}/device", timeout=60).json() == {"data": "cpu"}
    assert health["port"] == health["jax"]
    assert set(health["port"]["model"][2]) == {"sql", "kv", "file", "tpu", "slo", "model:lm"}
    assert set(health["port"]["gateway"][2]) == {"file", "slo", "service:model"}
    assert health["port"]["model"][1] == health["port"]["gateway"][1] == "UP"


def test_a_call_carries_its_trace_and_deadline_to_the_model_app(pairs):
    """The gateway's server span and the model App's share a trace id (the
    gateway's forward span goes out as ``traceparent``), and the model App
    reads the caller's deadline less the hop, in both packages."""
    for name, p in pairs.items():
        r = httpx.post(f"{p.gateway_h.base}/ask", json={"id": 100, "prompt": [3, 4]}, timeout=120,
                       headers={"X-Request-Deadline-Ms": str(int((time.time() + 60) * 1000))})
        assert r.status_code == 201, (name, r.text)
        got = p.model_seen[100]
        assert got["trace_id"] == p.gateway_seen[100], name
        assert got["traceparent"].split("-")[1] == p.gateway_seen[100], name
        assert got["deadline_s"] is not None and 50 < got["deadline_s"] <= 60, (name, got)


def test_the_breaker_opens_once_the_model_app_stops(pairs):
    """Last (it stops the model Apps): calls to the gateway answer 503, the
    breaker opens within ``THRESHOLD`` failed connections, and from then on
    fails fast without a connection; the same in both packages. The retry
    budget counts the retries it granted."""
    got = {}
    for name, p in pairs.items():
        p.model_h.__exit__(None, None, None)
        hist = p.gateway.container.metrics.get("app_http_service_response")
        statuses, opened_at = [], None
        for i in range(THRESHOLD + 2):
            r = httpx.post(f"{p.gateway_h.base}/ask", json={"id": 200 + i, "prompt": [1]},
                           timeout=60)
            statuses.append(r.status_code)
            if opened_at is None and r.json()["error"]["message"] == "circuit breaker is open":
                opened_at = i
        attempts = hist.count(service=p.model_h.base, method="POST", status="0")
        spent = p.gateway.container.metrics.get("app_retry_budget_spent_total").value()
        got[name] = (statuses, opened_at, attempts, spent)
    assert got["port"] == got["jax"]
    statuses, opened_at, attempts, spent = got["port"]
    assert statuses == [503] * (THRESHOLD + 2) and opened_at is not None
    assert attempts <= THRESHOLD + RETRIES and spent >= 1
