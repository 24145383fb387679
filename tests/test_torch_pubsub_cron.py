"""The port's pub/sub (gofr_tpu_torch/pubsub, the container's ``publish``,
``App.subscribe``) and cron (gofr_tpu_torch/cron.py, ``App.add_cron_job``)
held against the JAX package's.

Both serving examples run on the same tiny f32 weights (the port's on the
JAX engine's, ``params_from_jax``): a subscriber on ``prompts`` generates
and publishes to ``completions``, a second subscriber collects them, and
the same prompts give the same payloads and the same ``app_pubsub_*``
counts, on the in-memory and the file broker; a handler that fails leaves
its message uncommitted, and the rewind redelivers it (at-least-once). A
cron job's generate gives the JAX job's tokens, and tests/test_cron_cli.py's
parser and table cases (:16-95) hold on both modules. Tolerances: exact.
"""

import importlib.util
import os
import threading
import time

import jax
import numpy as np
import pytest

from tests.test_http_server import AppHarness, _free_port

torch = pytest.importorskip("torch")

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
PROMPTS = [[1, 2, 3], "pub sub", [5, 6, 7, 8], "cron"]
COUNTERS = ("app_pubsub_publish_total_count", "app_pubsub_publish_success_count",
            "app_pubsub_subscribe_total_count", "app_pubsub_subscribe_success_count")


def _load(name: str):
    path = os.path.join(EXAMPLES, name, "main.py")
    spec = importlib.util.spec_from_file_location(f"example_ps_{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _apps(extra: dict):
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu_torch.config import DictConfig

    def conf(tag):
        out = {"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port()), **extra}
        if "PUBSUB_DIR" in out:
            out["PUBSUB_DIR"] = os.path.join(out["PUBSUB_DIR"], tag)
        return out

    japp = _load("serving-llm").build_app(JaxConfig(conf("jax")))
    params = jax.tree.map(np.asarray, japp.container.engines["lm"].params)
    papp = _load("serving-llm-torch").build_app(DictConfig(conf("port")), params=params,
                                                device="cpu")
    return japp, papp


def _counts(app) -> dict:
    m = app.container.metrics
    return {(name, topic): m.get(name).value(topic=topic)
            for name in COUNTERS for topic in ("prompts", "completions")}


def _pipeline(app, fail_first: bool = False, workers_timeout: float = 120.0):
    """Subscribe, publish PROMPTS, collect the completions; with
    ``fail_first`` the first delivery of prompt 0 raises, and a rewind
    redelivers it."""
    done = []
    lock = threading.Lock()
    attempts = {}

    def on_prompt(ctx):
        body = ctx.bind(dict)
        with lock:
            attempts[body["id"]] = attempts.get(body["id"], 0) + 1
            first = attempts[body["id"]] == 1
        if fail_first and body["id"] == 0 and first:
            raise RuntimeError("planted handler fault")
        out = ctx.generate("lm", body["prompt"], max_new_tokens=5)
        ctx.publish("completions", {"id": body["id"], "tokens": out["tokens"],
                                    "text": out.get("text")})

    def on_completion(ctx):
        with lock:
            done.append(ctx.bind(dict))

    app.subscribe("prompts", on_prompt)
    app.subscribe("completions", on_completion)
    with AppHarness(app):
        for i, p in enumerate(PROMPTS):
            app.container.publish("prompts", {"id": i, "prompt": p})
        want = len(PROMPTS) - (1 if fail_first else 0)
        deadline = time.monotonic() + workers_timeout
        while time.monotonic() < deadline and len(done) < want:
            time.sleep(0.05)
        if fail_first:
            time.sleep(0.3)
            group = app.config.get_or_default("CONSUMER_GROUP", app.container.app_name)
            app.container.pubsub.rewind_uncommitted("prompts", group)
            # the offset stops at the failed message: all are redelivered
            while time.monotonic() < deadline and len(done) < 2 * len(PROMPTS) - 1:
                time.sleep(0.05)
        time.sleep(0.2)
    threads = [t for t in app._sub_threads if t.is_alive()]
    return sorted(done, key=lambda d: d["id"]), _counts(app), attempts, threads


@pytest.mark.quick
@pytest.mark.parametrize("backend", ["inmemory", "file"])
def test_generate_then_publish_equals_the_jax_app(backend, tmp_path):
    extra = {"PUBSUB_BACKEND": backend, "SUBSCRIBER_WORKERS": "2"}
    if backend == "file":
        extra["PUBSUB_DIR"] = str(tmp_path)
    got = [_pipeline(app) for app in _apps(extra)]
    assert got[0][:3] == got[1][:3]
    done, counts, _, threads = got[1]
    assert [d["id"] for d in done] == list(range(len(PROMPTS)))
    assert all(len(d["tokens"]) == 5 for d in done)
    assert set(counts.values()) == {float(len(PROMPTS))}
    assert threads == [], "consumer threads outlived the App"


@pytest.mark.quick
def test_a_failed_handler_is_redelivered_as_in_jax():
    got = [_pipeline(app, fail_first=True) for app in _apps({"PUBSUB_BACKEND": "inmemory"})]
    assert got[0][:3] == got[1][:3]
    done, counts, attempts, _ = got[1]
    # the group's offset stops at the failed message, so the rewind
    # redelivers it and every later one: at-least-once, never at-most
    assert {d["id"] for d in done} == set(range(len(PROMPTS)))
    assert attempts == {i: 2 for i in range(len(PROMPTS))}
    assert counts["app_pubsub_subscribe_total_count", "prompts"] == 2 * len(PROMPTS)
    assert counts["app_pubsub_subscribe_success_count", "prompts"] == 2 * len(PROMPTS) - 1


@pytest.mark.quick
def test_unported_brokers_raise_and_an_unknown_one_wires_nothing():
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container

    for backend in ("kafka", "google", "gcp", "mqtt"):
        with pytest.raises(ValueError, match="Queue A 10"):
            Container.create(DictConfig({"PUBSUB_BACKEND": backend}))
    c = Container.create(DictConfig({"PUBSUB_BACKEND": "carrier-pigeon"}))
    assert c.pubsub is None
    with pytest.raises(RuntimeError, match="PUBSUB_BACKEND"):
        c.publish("t", {"x": 1})
    c.close()


@pytest.mark.quick
def test_subscribe_without_a_broker_is_ignored_and_async_handlers_refused():
    """As in JAX: ``subscribe`` logs and ignores a topic without a broker;
    an ``async def`` handler fails its message (not committed)."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container, new_mock_container

    app = App(config=DictConfig({}), container=Container(DictConfig({})))
    app.subscribe("t", lambda ctx: None)
    assert app._subscriptions == {}

    conf = {"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port())}
    app = App(config=DictConfig(conf), container=new_mock_container(conf))

    async def handler(ctx):
        return None

    app.subscribe("t", handler)
    with AppHarness(app):
        app.container.publish("t", {"x": 1})
        time.sleep(1.0)
    m = app.container.metrics
    assert m.get("app_pubsub_subscribe_total_count").value(topic="t") == 1
    assert m.get("app_pubsub_subscribe_success_count").value(topic="t") == 0


# -- cron -------------------------------------------------------------------------


def _cron_mods():
    from gofr_tpu import cron as jax_cron
    from gofr_tpu_torch import cron as port_cron

    return [jax_cron, port_cron]


@pytest.mark.quick
@pytest.mark.parametrize("spec", ["* * * * *", "*/15 1-5 1,15 */3 0-6/2", "30 14 * * *",
                                  "0 0 1 * 1", "0 0 * * 1", "0 0 1 * *"])
def test_schedules_parse_and_match_as_in_jax(spec):
    """The parsed fields and the matches over a year of hours (Vixie's
    day-of-month / day-of-week OR rule included) equal JAX's."""
    jax_cron, port_cron = _cron_mods()
    js, ps = jax_cron.Schedule.parse(spec), port_cron.Schedule.parse(spec)
    assert (ps.minutes, ps.hours, ps.days, ps.months, ps.weekdays) == (
        js.minutes, js.hours, js.days, js.months, js.weekdays)
    t0 = time.mktime((2026, 1, 1, 0, 0, 0, 0, 0, -1))
    for h in range(0, 365 * 24, 7):
        for minute in (0, 15, 30):
            t = time.localtime(t0 + h * 3600 + minute * 60)
            assert ps.matches(t) == js.matches(t)
    if spec == "0 0 1 * 1":
        assert ps.matches(time.struct_time((2026, 6, 8, 0, 0, 0, 0, 159, -1)))
        assert not ps.matches(time.struct_time((2026, 6, 9, 0, 0, 0, 1, 160, -1)))


@pytest.mark.quick
@pytest.mark.parametrize("bad", ["* * * *", "60 * * * *", "* 24 * * *", "x * * * *",
                                 "*/0 * * * *", "5-1 * * * *", "* * 0 * *"])
def test_bad_schedules_are_refused(bad):
    for mod in _cron_mods():
        with pytest.raises(mod.CronParseError):
            mod.Schedule.parse(bad)


@pytest.mark.quick
def test_the_table_fires_once_a_minute_and_survives_a_failing_job():
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.cron import Crontab

    c = new_mock_container()
    cron = Crontab(c)
    fired = []
    cron.add_job("* * * * *", "always", lambda ctx: fired.append("always"))
    cron.add_job("59 23 31 12 *", "never-today", lambda ctx: fired.append("nope"))
    cron.add_job("* * * * *", "bad", lambda ctx: 1 / 0)
    names = cron.tick(time.mktime((2026, 7, 29, 10, 0, 0, 0, 0, -1)))
    assert names == ["always", "bad"]
    assert cron.tick(time.mktime((2026, 7, 29, 10, 0, 30, 0, 0, -1))) == []
    time.sleep(0.3)
    assert fired == ["always"]
    assert any("cron job bad failed" in r.get("message", "") for r in c.logger.records)
    assert cron.tick(time.mktime((2026, 7, 29, 10, 1, 0, 0, 0, -1))) == ["always", "bad"]
    cron.stop()


@pytest.mark.quick
def test_a_cron_job_s_generate_equals_the_jax_app_s():
    """``add_cron_job`` on both examples; a tick fires the job, whose
    generate gives the same tokens; ``arun`` started the table's thread
    and ``stop`` ended it."""
    got = []
    for app in _apps({}):
        out = []
        app.add_cron_job("* * * * *", "gen", lambda ctx, out=out: out.append(
            ctx.generate("lm", [3, 1, 4, 1, 5], max_new_tokens=6)["tokens"]))
        with AppHarness(app):
            assert app.cron._thread is not None and app.cron._thread.is_alive()
            assert app.cron.tick(time.time()) == ["gen"]
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and not out:
                time.sleep(0.05)
        assert not app.cron._thread.is_alive()
        got.append(out)
    assert got[0] == got[1] and len(got[1][0]) == 6
