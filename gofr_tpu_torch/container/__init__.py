"""Container: the dependency-injection hub (gofr `pkg/gofr/container/
container.go`), the port's own copy of gofr_tpu/container/__init__.py
reduced to what serving needs: config, logger, metrics, the tracer, the
flight recorder, the SLO engine and its capture watcher, the QoS
admission controller and the model engines, their health and their
shutdown, and since the App's other entry points the pub/sub backbone
(``PUBSUB_BACKEND``: ``inmemory`` or ``file``; ``publish`` with the
traceparent header and the four ``app_pubsub_*`` counters).

The engines take ``metrics``, ``logger``, ``tracer``, ``flight`` and
``slo`` from here (``GenerateEngine(model, container=...)``). The metric
families are the JAX package's ``app_tpu_*`` / ``app_qos_*`` /
``app_slo_*`` names, registered where the port has their producer; the
compile counters (``app_tpu_compile_total``, ``app_tpu_compile_cache_hits``)
have no eager counterpart and are left out. Datasources,
inter-service clients, the controller's gauges and fleet federation (the
quality counters' included) are not ported yet.
"""

from __future__ import annotations

import time
from typing import Any

import gofr_tpu_torch
from gofr_tpu_torch.config import DictConfig
from gofr_tpu_torch.logging import Level, Logger, MockLogger, new_logger
from gofr_tpu_torch.metrics import Registry, perf as perf_mod, sample_runtime_metrics
from gofr_tpu_torch.metrics.flight import FlightRecorder
from gofr_tpu_torch.metrics.slo import CaptureWatcher, SLOEngine
from gofr_tpu_torch.tracing import Tracer, tracer_from_config


class Container:
    def __init__(self, config, logger: Logger | None = None):
        self.config = config
        self.app_name = config.get_or_default("APP_NAME", "gofr-tpu-app")
        self.app_version = config.get_or_default("APP_VERSION", "dev")
        self.logger: Logger = logger or new_logger(config.get_or_default("LOG_LEVEL", "INFO"))
        self.metrics: Registry = Registry(logger=self.logger)
        self.tracer: Tracer = Tracer()
        # always-on ring of recent request timelines + engine steps (served
        # at /debug/requests, /debug/engine under APP_ENV=DEBUG)
        self.flight = FlightRecorder(
            max_requests=config.get_int("FLIGHT_REQUESTS", 256),
            max_steps=config.get_int("FLIGHT_STEPS", 512),
        )
        self._engines: dict[str, Any] = {}
        self.qos = None  # AdmissionController once App.enable_qos runs
        self.slo: SLOEngine | None = None  # once _maybe_slo runs (SLO_ENABLED)
        self.slo_capture: CaptureWatcher | None = None  # once SLO_CAPTURE opts in
        self.pubsub = None  # a broker once _maybe_pubsub wires PUBSUB_BACKEND

    @classmethod
    def create(cls, config) -> "Container":
        c = cls(config)
        c._register_framework_metrics()
        c.metrics.add_collect_hook(sample_runtime_metrics)
        c.metrics.add_collect_hook(c._sample_tpu_metrics)
        c.tracer = tracer_from_config(config, c.logger, c.app_name)
        c._maybe_slo()
        c._maybe_pubsub()
        return c

    def _register_framework_metrics(self) -> None:
        m = self.metrics
        g = m.new_gauge("app_info", "application info")
        g.set(1, app=self.app_name, version=self.app_version,
              framework=f"gofr_tpu_torch-{gofr_tpu_torch.__version__}")
        m.new_histogram("app_http_response", "HTTP handler latency (s)")
        m.new_counter("app_pubsub_publish_total_count", "pubsub publish attempts")
        m.new_counter("app_pubsub_publish_success_count", "pubsub publish successes")
        m.new_counter("app_pubsub_subscribe_total_count", "pubsub messages received")
        m.new_counter("app_pubsub_subscribe_success_count", "pubsub messages handled ok")
        # serving metrics under the JAX package's names (the card is the
        # "tpu" of app_tpu_*: dashboards written for it read the port)
        m.new_gauge("app_tpu_device_count", "visible CUDA devices")
        m.new_gauge("app_tpu_hbm_used_bytes", "per-device HBM in use")
        m.new_gauge("app_tpu_hbm_limit_bytes", "per-device HBM capacity")
        m.new_histogram("app_tpu_batch_occupancy", "occupied fraction of each device batch",
                        buckets=[0.1, 0.25, 0.5, 0.75, 0.9, 1.0])
        m.new_histogram("app_tpu_step_seconds", "device step wall time (s)")
        m.new_gauge("app_tpu_queue_depth", "requests waiting for a device step")
        m.new_counter("app_tpu_tokens_total", "tokens processed (prefill+decode)")
        m.new_gauge("app_tpu_kv_pages_free", "free pages in the paged KV pool")
        m.new_counter("app_tpu_preemptions", "slots preempted under KV pool pressure")
        m.new_counter("app_tpu_engine_restarts", "engine device-thread restarts")
        # hierarchical prefix cache: hit tokens carry a tier label (hbm =
        # pages already in the pool, host = pages swapped back in)
        m.new_counter("app_tpu_prefix_hit_tokens", "prompt tokens served from the prefix cache (by tier)")
        m.new_counter("app_tpu_prefix_lookup_total", "prefix-cache lookups at admission")
        m.new_counter("app_tpu_prefix_miss_total", "prefix-cache lookups that hit nothing")
        m.new_gauge("app_tpu_prefix_cached_pages", "KV pages held by the prefix cache in HBM")
        m.new_gauge("app_tpu_prefix_host_pages", "KV pages held by the host-DRAM cache tier")
        m.new_gauge("app_tpu_prefix_host_bytes", "bytes held by the host-DRAM cache tier")
        m.new_counter("app_tpu_prefix_evicted_pages_total",
                      "prefix-cache pages evicted (tier: hbm = left the pool, host = dropped from host DRAM)")
        m.new_counter("app_tpu_prefix_swapin_pages_total",
                      "host-tier pages swapped back into the device pool")
        m.new_histogram("app_tpu_prefix_swapin_seconds",
                        "host->device page swap-in latency, dispatch to fold (s)")
        m.new_histogram("app_tpu_prefix_swapin_bytes",
                        "bytes uploaded per host->device swap-in",
                        buckets=[2 ** 14, 2 ** 17, 2 ** 20, 2 ** 23, 2 ** 26, 2 ** 29])
        m.new_counter("app_tpu_spec_proposed", "draft tokens proposed by speculative decoding")
        m.new_counter("app_tpu_spec_accepted", "draft tokens accepted by target verification")
        m.new_counter("app_tpu_spec_pages_trimmed_total",
                      "KV pages claimed for spec over-claim and released at fold")
        m.new_counter("app_tpu_spec_tokens_rejected_total",
                      "spec draft tokens the target verification rejected")
        m.new_gauge("app_tpu_spec_accept_ratio",
                    "lifetime speculative-decode acceptance ratio (adapter)")
        # the quality plane (metrics/quality.py): shadow re-score divergence
        # against the reference arm, by what served the request
        m.new_histogram("app_tpu_quality_logprob_delta",
                        "mean |serving - reference| log-prob of the emitted "
                        "tokens, per shadow sample (kv_dtype, backend, adapter)",
                        buckets=[0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.0, 5.0])
        m.new_histogram("app_tpu_quality_kl",
                        "mean per-token KL(serving || reference), per shadow "
                        "sample (kv_dtype, backend, adapter)",
                        buckets=[0.0001, 0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0])
        m.new_gauge("app_tpu_quality_top1_agree",
                    "fraction of emitted tokens matching the reference "
                    "argmax, last shadow sample (kv_dtype, backend, adapter)")
        m.new_histogram("app_tpu_quality_first_divergence_token",
                        "token index of the first reference-argmax "
                        "disagreement (diverged samples only)",
                        buckets=[0, 1, 2, 4, 8, 16, 32, 64, 128])
        m.new_counter("app_tpu_quality_samples_total",
                      "shadow-scored requests (kv_dtype, backend, adapter)")
        m.new_counter("app_tpu_quality_good_total",
                      "shadow samples within divergence thresholds "
                      "(kv_dtype, backend, adapter)")
        m.new_counter("app_tpu_quality_shadow_dropped_total",
                      "sampled requests evicted from the bounded shadow "
                      "queue before scoring (back-pressure, never blocking)")
        # SLO latency family: recorded by the engine's device loop /
        # completion path regardless of QoS or tracing state
        m.new_histogram("app_tpu_queue_wait_seconds",
                        "enqueue-to-admission wait before the device loop picked the request")
        m.new_histogram("app_tpu_ttft_seconds", "time to first token (s)")
        m.new_histogram("app_tpu_tpot_seconds",
                        "time per output token after the first (s)",
                        buckets=[0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0])
        m.new_histogram("app_tpu_e2e_seconds",
                        "end-to-end request latency, submit to completion (by qos_class)")
        m.new_gauge("app_tpu_inflight_requests", "requests submitted but not yet complete")
        # QoS / admission control (all zero while QoS is off)
        m.new_counter("app_qos_admitted_total", "requests admitted by QoS")
        m.new_counter("app_qos_rejected_total",
                      "requests rejected by QoS (reason: rate/route_rate/key_rate/"
                      "tenant_rate/queue/deadline_exceeded/capacity/slo_burn)")
        m.new_counter("app_qos_shed_total", "requests shed under overload (503s)")
        m.new_gauge("app_qos_queue_depth", "queued requests per priority class")
        m.new_gauge("app_qos_predicted_wait_seconds",
                    "estimated queue wait per engine (EWMA step x backlog)")
        m.new_histogram("app_qos_queue_wait_seconds",
                        "time requests spent queued before reaching the device loop")
        m.new_counter("app_request_deadline_exceeded_total",
                      "requests shed because their deadline could not be met "
                      "(where = edge|qos|engine)")
        # SLO plane: attainment and error-budget burn per (class,
        # objective), refreshed by the SLOEngine collect hook on a scrape
        m.new_gauge("app_slo_attainment",
                    "fraction of samples meeting the objective (class, objective, window)")
        m.new_gauge("app_slo_burn_rate",
                    "error-budget burn rate; 1.0 = sustainable pace (class, objective, window)")
        m.new_gauge("app_slo_budget_remaining",
                    "slow-window error budget left, clamped to [0,1] (class, objective)")
        m.new_counter("app_slo_captures_total",
                      "burn-breach anomaly bundles written (SLO_CAPTURE)")
        m.new_counter("app_slo_captures_suppressed_total",
                      "burn-breach captures suppressed by the token-bucket rate limit")
        # live performance plane (metrics/perf.py): windowed roofline
        # utilization per step kind, derived at scrape time from the
        # engines' exact numerator/denominator sums
        m.new_gauge("app_tpu_mfu",
                    "windowed model-FLOPs utilization vs device peak "
                    "(kind, kv_dtype; absent while peaks are unknown)")
        m.new_gauge("app_tpu_mbu",
                    "windowed HBM-bandwidth utilization vs device peak "
                    "(kind, kv_dtype; absent while peaks are unknown)")
        m.new_gauge("app_tpu_perf_flops_window",
                    "analytical FLOPs folded in the perf window (kind, kv_dtype)")
        m.new_gauge("app_tpu_perf_bytes_window",
                    "analytical HBM bytes folded in the perf window (kind, kv_dtype)")
        m.new_gauge("app_tpu_perf_device_seconds_window",
                    "device-queue residency folded in the perf window (kind, kv_dtype)")
        m.new_histogram("app_tpu_step_device_seconds",
                        "per-step device-queue residency, pipeline overlap "
                        "deduplicated (kind)",
                        buckets=[0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                                 0.05, 0.1, 0.25, 1.0])
        m.new_gauge("app_tpu_pipeline_bubble_ratio",
                    "device-idle-while-work-queued fraction of the perf window")
        m.new_gauge("app_tpu_adapter_mfu",
                    "windowed MFU share attributed to one adapter (adapter)")
        m.new_gauge("app_tpu_adapter_mbu",
                    "windowed MBU share attributed to one adapter (adapter)")
        m.new_gauge("app_tpu_adapter_device_seconds",
                    "windowed device-seconds attributed to one adapter "
                    "(adapter) — the per-tenant COGS meter")
        m.new_gauge("app_tpu_weights_epoch",
                    "live base-weight epoch (bumped by every adoption; engine.adopt_weights)")
        m.new_counter("app_tpu_weight_swaps_total",
                      "full-model live weight adoptions (zero-drop hot-swap)")
        m.new_gauge("app_tpu_adapters_registered",
                    "adapters resident in the host registry tier")
        m.new_gauge("app_tpu_kv_pool_occupancy",
                    "allocated fraction of the paged KV pool (engine)")
        m.new_gauge("app_tpu_kv_pool_fragmentation",
                    "claimed-but-unwritten fraction of slot-held pages (engine)")
        # the online step controller (gofr_tpu_torch.control): decisions by
        # verdict, and the live knob vector per knob, so dashboards can
        # overlay knob moves on the MFU/bubble timelines they were judged by
        m.new_counter("app_tpu_control_decisions_total",
                      "step-controller decisions (verdict: try|commit|revert|resume|standdown)")
        m.new_gauge("app_tpu_control_knob", "live value of one engine tuning knob (engine, knob)")
        m.new_gauge("app_tpu_control_active",
                    "1 when the engine's step controller is constructed and not stood down "
                    "(engine)")
        # the split-plan autotuner (ops/autotune.py): info-style gauge, 1 on
        # the plan warmup pinned for an op, 0 on each candidate it beat
        m.new_gauge("app_tpu_kernel_backend",
                    "pinned attention-kernel backend per op (1 = op resolves "
                    "backend='auto' to this backend; labels: op, backend)")

    def _sample_tpu_metrics(self, _registry=None) -> None:
        """Collect hook: the card's memory on every /metrics scrape — read
        here, never on the dispatch path, and only for the cards a
        registered engine runs on (a scrape must never be the thing that
        initializes a device)."""
        devices = {e.device.index or 0 for e in self._engines.values()
                   if getattr(getattr(e, "device", None), "type", None) == "cuda"}
        if devices:
            import torch

            self.metrics.set_gauge("app_tpu_device_count", torch.cuda.device_count())
            for i in sorted(devices):
                try:
                    free, total = torch.cuda.mem_get_info(i)
                except Exception:  # noqa: BLE001 - scrape must not fail on a device hiccup
                    continue
                self.metrics.set_gauge("app_tpu_hbm_used_bytes", total - free, device=str(i))
                self.metrics.set_gauge("app_tpu_hbm_limit_bytes", total, device=str(i))
        # summed HERE rather than set by each engine: a per-engine write to
        # the shared gauge would report whichever engine completed last
        self.metrics.set_gauge(
            "app_tpu_inflight_requests",
            sum(getattr(e, "_inflight_requests", 0) for e in self._engines.values()))
        # spec-decode acceptance, divided at scrape time from raw
        # per-adapter (accepted, proposed) numerators summed across engines
        spec: dict[str, list[float]] = {}
        for e in self._engines.values():
            totals_fn = getattr(e, "spec_accept_totals", None)
            if not callable(totals_fn):
                continue
            for adapter, (acc, prop) in totals_fn().items():
                tot = spec.setdefault(adapter, [0.0, 0.0])
                tot[0] += acc
                tot[1] += prop
        for adapter, (acc, prop) in spec.items():
            if prop > 0:
                self.metrics.set_gauge("app_tpu_spec_accept_ratio", acc / prop, adapter=adapter)
        # the controller's surface: knob vectors are engine attributes, so
        # sampling them at scrape time keeps the device loop free of
        # metric writes on the knob-apply path
        for name, e in self._engines.items():
            kv_fn = getattr(e, "knob_vector", None)
            if not callable(kv_fn):
                continue
            for knob, value in kv_fn().items():
                self.metrics.set_gauge("app_tpu_control_knob", value, engine=name, knob=knob)
            ctl = getattr(e, "_control", None)
            self.metrics.set_gauge("app_tpu_control_active",
                                   1 if (ctl is not None and ctl.standdown is None) else 0,
                                   engine=name)
        self._sample_perf_metrics()

    def perf_totals(self) -> dict | None:
        """Exact sum-of-parts merge of every registered engine's perf
        window (metrics/perf.py payload shape). None when no engine
        carries a perf plane."""
        planes = [e.perf for e in self._engines.values()
                  if getattr(e, "perf", None) is not None]
        if not planes:
            return None
        now = time.monotonic()
        return perf_mod.merge_totals(p.window_totals(now) for p in planes)

    def _sample_perf_metrics(self) -> None:
        """Roofline gauges from the merged engine windows: numerators and
        capacity denominators are summed exactly across engines, the
        ratios derived once here (never averaged)."""
        totals = self.perf_totals()
        if totals is None:
            return
        for key, rec in totals["kinds"].items():
            kind, _, dtype = key.partition("|")
            labels = {"kind": kind, "kv_dtype": dtype}
            self.metrics.set_gauge("app_tpu_perf_flops_window", rec["flops"], **labels)
            self.metrics.set_gauge("app_tpu_perf_bytes_window", rec["bytes"], **labels)
            self.metrics.set_gauge("app_tpu_perf_device_seconds_window", rec["device_s"], **labels)
            if rec["flops_cap"]:
                self.metrics.set_gauge("app_tpu_mfu", rec["flops"] / rec["flops_cap"], **labels)
            if rec["bytes_cap"]:
                self.metrics.set_gauge("app_tpu_mbu", rec["bytes"] / rec["bytes_cap"], **labels)
        derived = perf_mod.derive(totals)
        for aid, rec in derived.get("adapters", {}).items():
            labels = {"adapter": aid}
            self.metrics.set_gauge("app_tpu_adapter_device_seconds", rec["device_s"], **labels)
            if rec.get("mfu") is not None:
                self.metrics.set_gauge("app_tpu_adapter_mfu", rec["mfu"], **labels)
            if rec.get("mbu") is not None:
                self.metrics.set_gauge("app_tpu_adapter_mbu", rec["mbu"], **labels)
        ratio = derived["bubble_ratio"]
        if ratio is not None:
            self.metrics.set_gauge("app_tpu_pipeline_bubble_ratio", ratio)
        for name, e in self._engines.items():
            stats_fn = getattr(e, "page_pool_stats", None)
            stats = stats_fn() if callable(stats_fn) else None
            if stats:
                self.metrics.set_gauge("app_tpu_kv_pool_occupancy", stats["occupancy"],
                                       engine=name)
                self.metrics.set_gauge("app_tpu_kv_pool_fragmentation", stats["fragmentation"],
                                       engine=name)

    def _maybe_slo(self) -> None:
        """Wire the SLO engine: on by default (``SLO_ENABLED``, as in JAX),
        since it is pure bookkeeping over samples the engines already
        record; and, only when the app opts in with ``SLO_CAPTURE``, the
        burn-breach capture watcher as its breach listener."""
        if not self.config.get_bool("SLO_ENABLED", True):
            return
        self.slo = SLOEngine.from_config(self.config, metrics=self.metrics, logger=self.logger)
        self.metrics.add_collect_hook(self.slo.sample_gauges)
        if self.config.get_bool("SLO_CAPTURE"):
            self.slo_capture = CaptureWatcher.from_config(self.config, self, self.slo)
            self.slo.add_breach_listener(self.slo_capture.on_breach)

    def _maybe_pubsub(self) -> None:
        backend = (self.config.get("PUBSUB_BACKEND") or "").lower()
        if not backend:
            return
        from gofr_tpu_torch.pubsub import connect_pubsub

        self.pubsub = connect_pubsub(backend, self.config, self.logger, self.metrics)

    # -- pub/sub (container/__init__.py:623-660) --------------------------------

    def publish(self, topic: str, payload: Any, headers: dict[str, str] | None = None) -> None:
        if self.pubsub is None:
            raise RuntimeError("no pubsub backend configured (set PUBSUB_BACKEND)")
        self.metrics.increment_counter("app_pubsub_publish_total_count", 1, topic=topic)
        # the W3C traceparent rides as a message header (both in-tree
        # brokers take headers), so the subscriber's span joins the trace
        self.pubsub.publish(topic, payload, headers=headers)
        self.metrics.increment_counter("app_pubsub_publish_success_count", 1, topic=topic)

    # -- QoS / admission control -----------------------------------------------

    def register_qos(self, controller: Any) -> None:
        """Install the app-wide AdmissionController (App.enable_qos): binds
        every already-served engine, exports the per-class gauges on each
        scrape, and joins health aggregation (DEGRADED while shedding).
        Re-registering replaces the old controller entirely — its scrape
        hook included, so a stale sampler can't keep writing gauges."""
        if self.qos is not None:
            self.metrics.remove_collect_hook(self.qos.sample_gauges)
        self.qos = controller
        self.metrics.add_collect_hook(controller.sample_gauges)
        for name, engine in self._engines.items():
            controller.bind_engine(name, engine)

    # -- model engines ---------------------------------------------------------

    def register_engine(self, name: str, engine: Any) -> None:
        self._engines[name] = engine
        if self.qos is not None:
            self.qos.bind_engine(name, engine)

    def engine(self, name: str):
        try:
            return self._engines[name]
        except KeyError:
            raise KeyError(
                f"no model {name!r} served; registered: {sorted(self._engines)}"
            ) from None

    @property
    def engines(self) -> dict[str, Any]:
        return dict(self._engines)

    def infer(self, model: str, inputs: Any, **kw: Any):
        return self.engine(model).infer(inputs, **kw)

    def generate(self, model: str, prompt: Any, **kw: Any):
        return self.engine(model).generate(prompt, **kw)

    # -- health aggregation (gofr `container/health.go`) -----------------------

    def health(self) -> dict[str, Any]:
        services: dict[str, Any] = {}
        down = 0

        def check(name: str, obj: Any) -> None:
            nonlocal down
            if obj is None:
                return
            try:
                h = obj.health_check() if hasattr(obj, "health_check") else {"status": "UP"}
            except Exception as e:  # noqa: BLE001
                h = {"status": "DOWN", "details": {"error": str(e)}}
            services[name] = h
            if h.get("status") != "UP":
                down += 1

        check("pubsub", self.pubsub)
        check("qos", self.qos)
        check("slo", self.slo)
        for name, engine in self._engines.items():
            check(f"model:{name}", engine)
        status = "UP" if down == 0 else ("DEGRADED" if down < max(len(services), 1) else "DOWN")
        models = [h for name, h in services.items() if name.startswith("model:")]
        if models and all(h.get("status") == "DOWN" for h in models):
            # An instance whose every model engine is DOWN (its restart
            # budget spent) serves nothing, so it reads DOWN (503) whatever
            # the QoS and SLO planes say. JAX's aggregate counts those
            # planes' UP and reads DEGRADED (200) here: a deliberate
            # deviation (ROADMAP Queue C).
            status = "DOWN"
        return {
            "status": status,
            "name": self.app_name,
            "version": self.app_version,
            "services": services,
        }

    # -- shutdown --------------------------------------------------------------

    def close(self) -> None:
        """Stop every engine, close the pub/sub broker, then the tracer (its
        exporter thread flushes and ends)."""
        for engine in self._engines.values():
            if hasattr(engine, "stop"):
                engine.stop()
        if self.pubsub is not None and hasattr(self.pubsub, "close"):
            try:
                self.pubsub.close()
            except Exception:  # noqa: BLE001 - shutdown goes on
                pass
        self.tracer.shutdown()


def new_mock_container(config: dict[str, str] | None = None) -> Container:
    """Hermetic container for handler tests (gofr `NewMockContainer`): mock
    logger, real metrics registry, the SLO engine as ``SLO_ENABLED`` says,
    in-memory pub/sub."""
    from gofr_tpu_torch.pubsub.inmemory import InMemoryBroker

    c = Container(DictConfig(config or {}), logger=MockLogger(level=Level.DEBUG))
    c._register_framework_metrics()
    c.metrics.add_collect_hook(c._sample_tpu_metrics)
    c._maybe_slo()  # mock containers skip create(); SLO must still wire
    c.pubsub = InMemoryBroker()
    return c
