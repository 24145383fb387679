"""QoS subsystem: admission control, priority scheduling, rate limiting,
and load shedding across the serving stack (the port's own copy of
gofr_tpu/qos/__init__.py; config keys, metric names and verdicts are the
JAX package's).

The reference framework accepts every request and lets it time out inside
the stack; under overload that *burns a device slot per doomed request*.
This subsystem rejects at the edge instead, in three tiers:

1. **Rate limiting** (``qos/limiter.py``) — token buckets, global and
   keyed by route / API key / tenant. Over-rate traffic gets HTTP 429
   with a ``Retry-After`` hint.
2. **Priority scheduling** (``qos/scheduler.py``) — the engine's FIFO
   queue becomes a weighted-fair, deadline-aware priority queue
   (``interactive`` > ``default`` > ``batch``); FIFO semantics are
   byte-for-byte preserved while QoS is off.
3. **Admission control + load shedding** (this module) — per-class
   concurrency caps, a max-backlog gate, and a queue-wait estimator
   (EWMA of ``app_tpu_step_seconds`` × backlog / lanes) that rejects
   work whose predicted wait already exceeds its deadline — HTTP 503
   with ``Retry-After``, *before* the request occupies anything.

Wiring: ``app.enable_qos()`` (or ``QOS_ENABLED=true``) builds one
``AdmissionController`` from ``QOS_*`` config, registers it on the
container (health: ``DEGRADED`` while shedding), inserts the HTTP
middleware, and binds every served engine (``bind_engine`` flips the
engine queue into priority mode and starts the wait estimator).
Observability: ``app_qos_admitted_total``, ``app_qos_rejected_total``
(by reason/class), ``app_qos_shed_total``, per-class
``app_qos_queue_depth`` gauges, ``app_qos_queue_wait_seconds``, and
per-engine ``app_qos_predicted_wait_seconds``; per-request, the admission
verdict rides the trace (``qos.class`` / ``qos.rejected`` span attributes)
and the class labels ``app_tpu_e2e_seconds`` plus the flight recorder's
``/debug/requests`` timelines.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from gofr_tpu_torch.http.errors import DeadlineExceeded, ServiceUnavailable, TooManyRequests
from gofr_tpu_torch.qos.limiter import KeyedBuckets, TokenBucket
from gofr_tpu_torch.qos.scheduler import QoSQueue

__all__ = [
    "AdmissionController",
    "Decision",
    "KeyedBuckets",
    "PriorityClass",
    "QoSPolicy",
    "QoSQueue",
    "TokenBucket",
]


@dataclass
class PriorityClass:
    """One scheduling class. ``weight`` sets the weighted-fair share under
    saturation; ``max_concurrency`` caps submitted-but-unfinished requests
    of this class per engine (0 = uncapped)."""

    name: str
    weight: float = 1.0
    max_concurrency: int = 0


# rank-ordered: interactive beats default beats batch at equal funding
DEFAULT_CLASSES = (
    PriorityClass("interactive", weight=8.0),
    PriorityClass("default", weight=4.0),
    PriorityClass("batch", weight=1.0),
)


@dataclass
class QoSPolicy:
    """Declarative QoS policy (config keys in parentheses; docs/qos.md).

    ``classes`` must be rank-ordered, highest priority first. The policy
    is also the class vocabulary of the SLO engine (``metrics/slo.py``),
    which builds one from the same config, so both agree on what an
    unknown class means."""

    classes: list[PriorityClass] = field(default_factory=lambda: list(DEFAULT_CLASSES))
    default_class: str = "default"          # QOS_DEFAULT_CLASS
    rate_rps: float = 0.0                   # QOS_RATE_RPS (global; 0 = off)
    rate_burst: float = 0.0                 # QOS_RATE_BURST (default = rps)
    route_rps: float = 0.0                  # QOS_ROUTE_RPS (per route)
    key_rps: float = 0.0                    # QOS_KEY_RPS (per X-API-KEY)
    tenant_rps: float = 0.0                 # QOS_TENANT_RPS (per X-Tenant-ID)
    max_queue: int = 0                      # QOS_MAX_QUEUE (backlog shed; 0 = off)
    shed_window_s: float = 10.0             # QOS_SHED_WINDOW_S (DEGRADED window)
    shed_on_burn: bool = False              # QOS_SHED_ON_BURN (SLO pressure signal)
    class_header: str = "X-QoS-Class"       # QOS_CLASS_HEADER
    tenant_header: str = "X-Tenant-ID"      # QOS_TENANT_HEADER

    def __post_init__(self):
        self._by_name = {c.name: c for c in self.classes}
        if self.default_class not in self._by_name:
            raise ValueError(
                f"QoS default class {self.default_class!r} is not one of "
                f"{sorted(self._by_name)}"
            )

    def resolve(self, name: str | None) -> PriorityClass:
        """Class by name; unknown/absent names land in the default class
        (a client must not gain OR lose service by inventing a class)."""
        if name:
            cls = self._by_name.get(str(name))
            if cls is not None:
                return cls
        return self._by_name[self.default_class]

    @classmethod
    def from_config(cls, config, **overrides: Any) -> "QoSPolicy":
        """Build from ``QOS_*`` config keys; ``overrides`` win (the
        ``enable_qos(**kw)`` programmatic path). ``QOS_CLASSES`` is
        ``name:weight[:max_concurrency],...`` rank-ordered, e.g.
        ``interactive:8:16,default:4,batch:1:4``."""
        kw: dict[str, Any] = {}
        spec = config.get_or_default("QOS_CLASSES", "")
        if spec:
            classes = []
            for part in spec.split(","):
                bits = part.strip().split(":")
                if not bits[0]:
                    continue
                classes.append(PriorityClass(
                    bits[0],
                    weight=float(bits[1]) if len(bits) > 1 and bits[1] else 1.0,
                    max_concurrency=int(bits[2]) if len(bits) > 2 and bits[2] else 0,
                ))
            if classes:
                kw["classes"] = classes
                kw["default_class"] = config.get_or_default(
                    "QOS_DEFAULT_CLASS",
                    "default" if any(c.name == "default" for c in classes)
                    else classes[-1].name)
        else:
            kw["default_class"] = config.get_or_default("QOS_DEFAULT_CLASS", "default")
        kw["rate_rps"] = config.get_float("QOS_RATE_RPS", 0.0)
        kw["rate_burst"] = config.get_float("QOS_RATE_BURST", 0.0)
        kw["route_rps"] = config.get_float("QOS_ROUTE_RPS", 0.0)
        kw["key_rps"] = config.get_float("QOS_KEY_RPS", 0.0)
        kw["tenant_rps"] = config.get_float("QOS_TENANT_RPS", 0.0)
        kw["max_queue"] = config.get_int("QOS_MAX_QUEUE", 0)
        kw["shed_window_s"] = config.get_float("QOS_SHED_WINDOW_S", 10.0)
        kw["shed_on_burn"] = config.get_bool("QOS_SHED_ON_BURN")
        kw["class_header"] = config.get_or_default("QOS_CLASS_HEADER", "X-QoS-Class")
        kw["tenant_header"] = config.get_or_default("QOS_TENANT_HEADER", "X-Tenant-ID")
        kw.update(overrides)
        return cls(**kw)


@dataclass
class Decision:
    """Transport-tier admission verdict. ``status`` is the HTTP status the
    transport should return (gRPC maps 429 → RESOURCE_EXHAUSTED, 503 →
    UNAVAILABLE); ``retry_after`` feeds the Retry-After header/metadata."""

    allowed: bool
    status: int = 200
    retry_after: float = 0.0
    reason: str = ""
    message: str = ""


class AdmissionController:
    """The QoS brain: owns the policy, the rate-limit buckets, the
    per-class concurrency accounting, and the queue-wait estimator.

    One controller serves the whole app — transports call
    ``admit_transport`` before handlers run; bound engines call
    ``admit_engine`` inside ``_submit`` (rejections raise typed HTTP
    errors that every transport already maps, carrying ``retry_after``).
    """

    def __init__(self, policy: QoSPolicy, metrics, logger=None):
        self.policy = policy
        self.metrics = metrics
        self.logger = logger
        burst = policy.rate_burst or None
        self._global = TokenBucket(policy.rate_rps, burst)
        self._routes = KeyedBuckets(policy.route_rps)
        self._keys = KeyedBuckets(policy.key_rps)
        self._tenants = KeyedBuckets(policy.tenant_rps)
        self._engines: dict[str, Any] = {}
        self._inflight: dict[str, int] = {c.name: 0 for c in policy.classes}
        self._ewma_step = 0.0
        self._last_shed = 0.0
        self._lock = threading.Lock()

    # -- engine binding --------------------------------------------------------

    def bind_engine(self, name: str, engine) -> None:
        """Attach QoS to an engine: flips its queue into priority mode and
        points the engine's submit/step hooks at this controller."""
        self._engines[name] = engine
        queue = getattr(engine, "_queue", None)
        if isinstance(queue, QoSQueue):
            queue.set_policy(self.policy, metrics=self.metrics)
        engine.qos = self

    # -- wait estimation -------------------------------------------------------

    def observe_step(self, seconds: float) -> None:
        """EWMA of device-step wall time, fed by ``_record_step`` on every
        bound engine (one estimator app-wide: steps across engines in one
        process contend for the same host/device anyway). Under the unified
        async pipeline steps are observed at COMPLETION (dequeue) time, so
        a sample spans dispatch→fold — slightly pessimistic while calls
        overlap, which is the right bias for shedding hopeless work."""
        with self._lock:
            self._ewma_step = (seconds if self._ewma_step == 0.0
                               else 0.2 * seconds + 0.8 * self._ewma_step)

    def predicted_wait(self, engine) -> float:
        """Estimated queue wait: EWMA step seconds × backlog / lanes, where
        lanes is the engine's concurrency (decode slots or max batch) — an
        upper-ish bound that only has to be right about *hopeless*, not
        about milliseconds."""
        backlog = engine._backlog()
        if backlog <= 0:
            return 0.0
        lanes = max(1, int(getattr(engine, "num_slots", 0)
                           or getattr(engine, "max_batch", 1)))
        return self._ewma_step * math.ceil(backlog / lanes)

    # -- admission -------------------------------------------------------------

    def classify(self, headers) -> str:
        """Priority-class name from request headers (unknown → default)."""
        raw = headers.get(self.policy.class_header) if headers else None
        return self.policy.resolve(raw).name

    def admit_transport(self, route: str = "", api_key: str = "",
                        tenant: str = "", cls_name: str | None = None) -> Decision:
        """Tier-1 gate, called by the HTTP middleware / gRPC interceptor
        before the handler runs: rate limits (429), then backlog shedding
        (503). Admission increments ``app_qos_admitted_total``."""
        cls = self.policy.resolve(cls_name)
        # most-specific limiter first, short-circuiting: a flooding tenant
        # must be rejected by ITS bucket before any shared bucket is
        # consulted — eager evaluation here would let doomed traffic drain
        # the global budget and starve well-behaved tenants
        for reason, acquire in (
            ("tenant_rate", (lambda: self._tenants.acquire(tenant)) if tenant else None),
            ("key_rate", (lambda: self._keys.acquire(api_key)) if api_key else None),
            ("route_rate", (lambda: self._routes.acquire(route)) if route else None),
            ("rate", lambda: self._global.acquire()),
        ):
            wait = acquire() if acquire is not None else 0.0
            if wait > 0.0:
                self._reject(cls, reason, 429, wait)
                return Decision(False, 429, wait, reason,
                                "rate limit exceeded; retry later")
        if self.policy.max_queue and self._engines:
            # max_queue is a PER-ENGINE ceiling (admit_engine enforces it
            # for the request's actual engine); the transport — which does
            # not know the target engine yet — sheds only when EVERY bound
            # engine is at the ceiling, so one full engine can't 503
            # traffic headed for an idle one
            backlog = min(e._backlog() for e in self._engines.values())
            if backlog >= self.policy.max_queue:
                wait = max((self.predicted_wait(e) for e in self._engines.values()),
                           default=1.0) or 1.0
                self._reject(cls, "queue", 503, wait)
                return Decision(False, 503, wait, "queue",
                                "server overloaded; retry later")
        self.metrics.increment_counter("app_qos_admitted_total", 1,
                                       qos_class=cls.name)
        return Decision(True)

    def admit_engine(self, engine, cls_name: str | None,
                     timeout: float | None) -> PriorityClass:
        """Tier-3 gate, called by ``_EngineBase._submit``: backlog cap,
        per-class concurrency cap, then the deadline check — if the
        predicted queue wait already exceeds the request's remaining
        budget (propagated deadline or explicit timeout) it is rejected
        NOW with 504/``deadline_exceeded`` instead of burning a slot and
        timing out later (docs/resilience.md). Returns the resolved
        class (capacity acquired; released by the request's done
        callback via ``track``)."""
        cls = self.policy.resolve(cls_name)
        if getattr(engine, "_restarting", False):
            # shed-during-restart: the device loop is inside its crash-
            # recovery backoff window — new work would only deepen the
            # backlog the restarted loop must drain (queued work already
            # there survives the restart; docs/qos.md)
            wait = self._ewma_step or 1.0
            self._reject(cls, "restart", 503, wait)
            raise ServiceUnavailable(
                "engine restarting after a device fault; retry later",
                retry_after=wait)
        if self.policy.shed_on_burn:
            # SLO pressure signal (metrics/slo.py, QOS_SHED_ON_BURN): while
            # a strictly higher-priority class is burning its fast-window
            # error budget, lower classes are shed — the freed capacity is
            # exactly what the burning class needs (docs/qos.md)
            slo = getattr(engine, "slo", None)
            if slo is not None and slo.should_shed(cls.name):
                wait = self._ewma_step or 1.0
                self._reject(cls, "slo_burn", 503, wait)
                raise ServiceUnavailable(
                    f"class {cls.name!r} shed while a higher class burns "
                    "its SLO error budget; retry later", retry_after=wait)
        if self.policy.max_queue and engine._backlog() >= self.policy.max_queue:
            wait = self.predicted_wait(engine) or 1.0
            self._reject(cls, "queue", 503, wait)
            raise ServiceUnavailable("engine queue full; retry later",
                                     retry_after=wait)
        predicted = self.predicted_wait(engine)
        if timeout and predicted > timeout:
            # the request-lifetime plane (docs/resilience.md): the caller's
            # budget — propagated deadline or explicit timeout — cannot be
            # met even before a slot is taken. 504/DEADLINE_EXCEEDED, not
            # 503: retrying the same deadline is pointless, so no hint.
            self._reject(cls, "deadline_exceeded", 504, predicted)
            self.metrics.increment_counter(
                "app_request_deadline_exceeded_total", 1, where="qos")
            raise DeadlineExceeded(
                f"predicted queue wait {predicted:.2f}s exceeds deadline "
                f"{timeout:.2f}s")
        if cls.max_concurrency:
            with self._lock:
                if self._inflight[cls.name] >= cls.max_concurrency:
                    wait = predicted or self._ewma_step or 1.0
                    capped = True
                else:
                    self._inflight[cls.name] += 1
                    capped = False
            if capped:
                self._reject(cls, "capacity", 429, wait)
                raise TooManyRequests(
                    f"class {cls.name!r} at its concurrency cap "
                    f"({cls.max_concurrency})", retry_after=wait)
        self.metrics.increment_counter("app_qos_admitted_total", 1,
                                       qos_class=cls.name)
        return cls

    def track(self, request, cls: PriorityClass) -> None:
        """Release the class's concurrency share when the request
        completes (success, error, timeout, or engine death alike)."""
        if cls.max_concurrency:
            request.add_done_callback(lambda _r: self._release(cls.name))

    def _release(self, name: str) -> None:
        with self._lock:
            self._inflight[name] = max(0, self._inflight[name] - 1)

    def _reject(self, cls: PriorityClass, reason: str, status: int,
                retry_after: float) -> None:
        self.metrics.increment_counter("app_qos_rejected_total", 1,
                                       reason=reason, qos_class=cls.name)
        if reason in ("queue", "deadline_exceeded", "capacity", "slo_burn", "restart"):
            # overload-driven (we turned away feasible work because of
            # load), as opposed to a client exceeding its rate budget —
            # this is what flips health to DEGRADED for the shed window
            self.metrics.increment_counter("app_qos_shed_total", 1,
                                           reason=reason)
            with self._lock:
                self._last_shed = time.monotonic()

    # -- observability ---------------------------------------------------------

    @property
    def shedding(self) -> bool:
        """True while a 503 shed happened within the policy window — the
        health signal (DEGRADED) operators and load balancers act on."""
        return (time.monotonic() - self._last_shed) < self.policy.shed_window_s \
            if self._last_shed else False

    def health_check(self) -> dict[str, Any]:
        details = {
            "inflight": dict(self._inflight),
            "ewma_step_s": round(self._ewma_step, 6),
        }
        if self.shedding:
            details["shedding"] = True
            return {"status": "DEGRADED", "details": details}
        return {"status": "UP", "details": details}

    def sample_gauges(self, _registry=None) -> None:
        """Metrics collect hook: per-class queue depth (summed across
        engines) and per-engine predicted wait, refreshed on scrape."""
        depths: dict[str, int] = {c.name: 0 for c in self.policy.classes}
        for name, engine in self._engines.items():
            q = getattr(engine, "_queue", None)
            if isinstance(q, QoSQueue):
                for cname, depth in q.depths().items():
                    depths[cname] = depths.get(cname, 0) + depth
            self.metrics.set_gauge("app_qos_predicted_wait_seconds",
                                   self.predicted_wait(engine), engine=name)
        for cname, depth in depths.items():
            self.metrics.set_gauge("app_qos_queue_depth", depth, qos_class=cname)
