"""SLO engine: per-QoS-class objectives, rolling attainment, error budgets
(the port's own copy of gofr_tpu/metrics/slo.py).

The engine records raw latency histograms (``app_tpu_{ttft,tpot,e2e}
_seconds``); this module turns those same samples into the signal operators
actually page on — *is each class meeting its objective, and how fast is it
burning error budget* (Google-SRE multi-window burn-rate alerting).

Objectives are declarative, per QoS class, config-driven with sane defaults
(``SLO_ENABLED``; ``SLO_<CLASS>_TTFT_MS`` / ``_TPOT_MS`` / ``_E2E_MS`` /
``_AVAILABILITY`` / ``_TARGET``, ``SLO_TARGET``, ``SLO_FAST_WINDOW_S``,
``SLO_SLOW_WINDOW_S``, ``SLO_BURN_THRESHOLD``, ``SLO_MIN_SAMPLES``,
). Each (class, objective) pair keeps two bucketed
ring windows — fast (~1m) and slow (~1h), fixed memory, no per-sample
retention — and derives:

- **attainment**: fraction of samples meeting the objective in the window,
  exported as ``app_slo_attainment{class,objective,window}``;
- **burn rate**: ``(1 - attainment) / (1 - target)`` — 1.0 means the error
  budget is being consumed exactly at the sustainable pace, N means N× too
  fast (``app_slo_burn_rate{...}``);
- **budget remaining**: ``1 - burn`` over the slow window, clamped to
  [0, 1] (``app_slo_budget_remaining{class,objective}``).

A sustained fast-window burn above ``SLO_BURN_THRESHOLD`` (with at least
``SLO_MIN_SAMPLES`` samples — a single slow request must not page anyone)
flips ``health_check()`` to DEGRADED with the breaching (class, objective,
burn) as a structured reason; the container joins it into ``/.well-known/
health``. QoS's admission controller may consult ``should_shed`` as a
pressure signal (``QOS_SHED_ON_BURN``: shed lower classes while a higher
class burns). Breach listeners hear the breach list at most once per
``SLO_CHECK_INTERVAL_S`` while one persists.

``CaptureWatcher`` is the trigger-fired anomaly capture (off unless
``SLO_CAPTURE=true``): on a burn-rate breach it writes the flight recorder
rings, the engines' health, their perf and quality snapshots and the SLO
state to a timestamped bundle under ``SLO_CAPTURE_DIR`` (else
``PROFILER_DIR``), token-bucket rate-limited (``SLO_CAPTURE_MIN_INTERVAL_S``,
``SLO_CAPTURE_BURST``) and swept to ``SLO_CAPTURE_MAX_BUNDLES``. With
``SLO_CAPTURE_TRACE_S`` > 0 it also records that many seconds of the card
with ``torch.profiler`` (CUDA activity, which the profiler takes for the
whole process, the engine's thread included) into the bundle's
``trace/trace.json``, where JAX records a ``jax.profiler`` trace.

Feed points: the engine's device loop / completion path (gpu/engine.py
``_mark_first_token`` → ttft, ``_maybe_finish`` → tpot, ``_observe_done`` →
e2e + availability) — the exact callsites that record the raw histograms,
so the two views can never disagree about what was measured — and the
quality plane's ``observe_quality`` (``metrics/quality.py``) for
``SLO_<CLASS>_QUALITY``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["CaptureWatcher", "Objective", "SLOEngine", "SLOTracker"]

LATENCY_OBJECTIVES = ("ttft", "tpot", "e2e")

# sane defaults (ms): overridable per class via SLO_<CLASS>_<OBJ>_MS; a
# class outside this table inherits the "default" row. 0/negative disables
# that (class, objective) pair.
_DEFAULT_THRESHOLDS_MS: dict[str, dict[str, float]] = {
    "interactive": {"ttft": 2000.0, "tpot": 100.0, "e2e": 30000.0},
    "default": {"ttft": 5000.0, "tpot": 250.0, "e2e": 60000.0},
    "batch": {"ttft": 30000.0, "tpot": 1000.0, "e2e": 300000.0},
}
_DEFAULT_AVAILABILITY = {"interactive": 0.999, "default": 0.99, "batch": 0.95}


@dataclass(frozen=True)
class Objective:
    """One declarative (class, objective) target. ``threshold_s`` is the
    latency bound a sample must meet (None for availability, where the
    sample itself is already good/bad); ``target`` is the attainment
    fraction the error budget is sized against (0.99 → 1% budget)."""

    cls: str
    name: str                   # ttft | tpot | e2e | availability
    target: float
    threshold_s: float | None = None


class _WindowRing:
    """Bucketed time ring covering ``window_s``: O(buckets) memory forever,
    regardless of traffic. Each bucket stores (good, total) for one
    ``window_s / buckets`` slice; a write to a recycled slot resets it, so
    reads just skip slots whose last-write epoch fell out of the window.
    The newest partial bucket is included, so a window can briefly see up
    to one bucket-width of extra history — irrelevant at 60 buckets."""

    __slots__ = ("width", "n", "_good", "_total", "_epoch")

    def __init__(self, window_s: float, buckets: int = 60):
        self.n = max(1, int(buckets))
        self.width = float(window_s) / self.n
        self._good = [0] * self.n
        self._total = [0] * self.n
        self._epoch = [-1] * self.n

    def observe(self, ok: bool, now: float) -> None:
        idx = int(now / self.width)
        slot = idx % self.n
        if self._epoch[slot] != idx:
            self._epoch[slot] = idx
            self._good[slot] = 0
            self._total[slot] = 0
        self._total[slot] += 1
        if ok:
            self._good[slot] += 1

    def stats(self, now: float) -> tuple[int, int]:
        lo = int(now / self.width) - self.n + 1
        good = total = 0
        for slot in range(self.n):
            if self._epoch[slot] >= lo:
                good += self._good[slot]
                total += self._total[slot]
        return good, total


class SLOTracker:
    """Attainment/burn state for one (class, objective): a fast and a slow
    window ring plus the derived SRE arithmetic."""

    __slots__ = ("objective", "fast", "slow")

    def __init__(self, objective: Objective, fast_s: float, slow_s: float,
                 buckets: int = 60):
        self.objective = objective
        self.fast = _WindowRing(fast_s, buckets)
        self.slow = _WindowRing(slow_s, buckets)

    def observe(self, ok: bool, now: float) -> None:
        self.fast.observe(ok, now)
        self.slow.observe(ok, now)

    def burn(self, good: int, total: int) -> float | None:
        """Error-budget burn rate: bad fraction over budget fraction. 1.0 =
        burning exactly at the sustainable pace; None with no samples or a
        degenerate target (budget 0)."""
        budget = 1.0 - self.objective.target
        if total <= 0 or budget <= 0:
            return None
        return (1.0 - good / total) / budget

    def window(self, which: str, now: float) -> dict[str, Any]:
        ring = self.fast if which == "fast" else self.slow
        good, total = ring.stats(now)
        att = good / total if total else None
        burn = self.burn(good, total)
        return {
            "good": good, "total": total,
            "attainment": round(att, 6) if att is not None else None,
            "burn_rate": round(burn, 4) if burn is not None else None,
        }


class SLOEngine:
    """The per-process SLO brain: owns the (class, objective) trackers,
    exports the three ``app_slo_*`` gauge families on every scrape and
    flips health to DEGRADED on sustained fast-window burn; breach
    listeners hear the breaches at most once per ``check_interval_s``.
    Thread-safe; ``now`` is injectable for tests."""

    def __init__(self, objectives: list[Objective], *, metrics=None,
                 logger=None, fast_window_s: float = 60.0,
                 slow_window_s: float = 3600.0, burn_threshold: float = 10.0,
                 min_samples: int = 10, check_interval_s: float = 1.0,
                 default_class: str = "default",
                 rank: dict[str, int] | None = None,
                 now: Callable[[], float] = time.monotonic):
        self.metrics = metrics
        self.logger = logger
        self.check_interval_s = float(check_interval_s)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.min_samples = int(min_samples)
        self.default_class = default_class
        self._now = now
        self._rank = dict(rank or {})
        self._trackers: dict[tuple[str, str], SLOTracker] = {
            (o.cls, o.name): SLOTracker(o, fast_window_s, slow_window_s)
            for o in objectives
        }
        self._classes = {o.cls for o in objectives}
        if default_class not in self._classes and self._trackers:
            # an explicit vocabulary without "default": unlabeled samples
            # land in the lowest-priority class rather than vanishing
            self.default_class = min(
                self._classes, key=lambda c: -self._rank.get(c, 0))
        self._lock = threading.Lock()
        self._listeners: list[Callable[[list[dict]], Any]] = []
        self._last_check = 0.0

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_config(cls, config, *, metrics=None, logger=None,
                    now: Callable[[], float] = time.monotonic) -> "SLOEngine":
        """Build from ``SLO_*`` config. The class vocabulary (and the
        priority rank ``should_shed`` uses) comes from the same ``QOS_*``
        keys the admission controller reads, so both tiers
        agree on what a class name means."""
        from gofr_tpu_torch.qos import QoSPolicy

        qpol = QoSPolicy.from_config(config)
        names = [c.name for c in qpol.classes]
        rank = {name: i for i, name in enumerate(names)}
        base_target = config.get_float("SLO_TARGET", 0.99)
        objectives: list[Objective] = []
        for name in names:
            up = name.upper()
            defaults = _DEFAULT_THRESHOLDS_MS.get(
                name, _DEFAULT_THRESHOLDS_MS["default"])
            target = config.get_float(f"SLO_{up}_TARGET", base_target)
            for obj in LATENCY_OBJECTIVES:
                ms = config.get_float(f"SLO_{up}_{obj.upper()}_MS",
                                      defaults[obj])
                if ms > 0:
                    objectives.append(Objective(name, obj, target, ms / 1000.0))
            avail = config.get_float(
                f"SLO_{up}_AVAILABILITY",
                _DEFAULT_AVAILABILITY.get(name, _DEFAULT_AVAILABILITY["default"]))
            if 0.0 < avail < 1.0:
                objectives.append(Objective(name, "availability", avail))
            # quality objective, fed by the quality plane's shadow scorer
            # (metrics/quality.py, QUALITY_SHADOW_RATE). Default 0 = off.
            quality = config.get_float(f"SLO_{up}_QUALITY", 0.0)
            if 0.0 < quality < 1.0:
                objectives.append(Objective(name, "quality", quality))
        return cls(
            objectives, metrics=metrics, logger=logger,
            fast_window_s=config.get_float("SLO_FAST_WINDOW_S", 60.0),
            slow_window_s=config.get_float("SLO_SLOW_WINDOW_S", 3600.0),
            burn_threshold=config.get_float("SLO_BURN_THRESHOLD", 10.0),
            min_samples=config.get_int("SLO_MIN_SAMPLES", 10),
            check_interval_s=config.get_float("SLO_CHECK_INTERVAL_S", 1.0),
            default_class=qpol.default_class, rank=rank, now=now)

    # -- feeds (engine record points) ------------------------------------------

    def _canon(self, cls_name: str | None) -> str:
        """Unknown/absent class labels (QoS off records "none") fold into
        the default class, mirroring ``QoSPolicy.resolve``."""
        if cls_name in self._classes:
            return cls_name  # type: ignore[return-value]
        return self.default_class

    def observe(self, cls_name: str | None, objective: str, seconds: float) -> None:
        """One latency sample against the (class, objective) threshold.
        No-op for disabled objectives — the hot path pays a dict probe."""
        tr = self._trackers.get((self._canon(cls_name), objective))
        if tr is None or tr.objective.threshold_s is None:
            return
        now = self._now()
        with self._lock:
            tr.observe(seconds <= tr.objective.threshold_s, now)
        self._maybe_check(now)

    def observe_outcome(self, cls_name: str | None, ok: bool) -> None:
        """One availability sample: did the request complete without error
        (timeouts, sheds, and engine faults all count against budget)."""
        tr = self._trackers.get((self._canon(cls_name), "availability"))
        if tr is None:
            return
        now = self._now()
        with self._lock:
            tr.observe(bool(ok), now)
        self._maybe_check(now)

    def observe_quality(self, cls_name: str | None, ok: bool) -> None:
        """One shadow-scored quality sample (metrics/quality.py): did the
        request's re-score stay within the divergence thresholds. It rides
        the windows, burn and breach listeners of every other objective."""
        tr = self._trackers.get((self._canon(cls_name), "quality"))
        if tr is None:
            return
        now = self._now()
        with self._lock:
            tr.observe(bool(ok), now)
        self._maybe_check(now)

    # -- derived views ---------------------------------------------------------

    def snapshot(self, now: float | None = None) -> dict[str, Any]:
        """Nested {class: {objective: windows}} view (window good/total
        counts ride along so an aggregation can merge them EXACTLY:
        attainment is a ratio of counts, so a merged number is
        sum(good)/sum(total), never an average of ratios)."""
        t = self._now() if now is None else now
        out: dict[str, Any] = {}
        with self._lock:
            items = list(self._trackers.items())
        for (cname, oname), tr in items:
            with self._lock:
                fast = tr.window("fast", t)
                slow = tr.window("slow", t)
            burn_slow = slow["burn_rate"]
            entry: dict[str, Any] = {
                "target": tr.objective.target,
                "fast": fast, "slow": slow,
                "budget_remaining": (
                    round(max(0.0, min(1.0, 1.0 - burn_slow)), 4)
                    if burn_slow is not None else None),
            }
            if tr.objective.threshold_s is not None:
                entry["threshold_ms"] = tr.objective.threshold_s * 1000.0
            out.setdefault(cname, {})[oname] = entry
        return out

    def breaches(self, now: float | None = None) -> list[dict[str, Any]]:
        """(class, objective) pairs whose FAST-window burn sits at or above
        the threshold with enough samples to mean something — the
        structured reason behind DEGRADED health and the capture trigger."""
        t = self._now() if now is None else now
        out = []
        with self._lock:
            for (cname, oname), tr in self._trackers.items():
                good, total = tr.fast.stats(t)
                if total < self.min_samples:
                    continue
                burn = tr.burn(good, total)
                if burn is not None and burn >= self.burn_threshold:
                    out.append({
                        "class": cname, "objective": oname, "window": "fast",
                        "burn_rate": round(burn, 4),
                        "attainment": round(good / total, 6),
                        "samples": total, "target": tr.objective.target,
                    })
        return out

    def burning_classes(self, now: float | None = None) -> set[str]:
        return {b["class"] for b in self.breaches(now)}

    def should_shed(self, cls_name: str | None, now: float | None = None) -> bool:
        """QoS pressure signal (``QOS_SHED_ON_BURN``): shed this class when
        a STRICTLY higher-priority class is burning its fast budget — the
        capacity freed is exactly what the burning class needs, and the
        burning class itself is never shed by its own burn (that would turn
        every breach into an outage)."""
        mine = self._rank.get(self._canon(cls_name), 0)
        return any(self._rank.get(c, mine) < mine
                   for c in self.burning_classes(now))

    def health_check(self) -> dict[str, Any]:
        br = self.breaches()
        if br:
            return {"status": "DEGRADED", "details": {"burning": br}}
        return {"status": "UP", "details": {"burning": []}}

    # -- exposition ------------------------------------------------------------

    def sample_gauges(self, registry=None) -> None:
        """Metrics collect hook: refresh the three ``app_slo_*`` families
        on every scrape. Windows with zero samples publish nothing — an
        idle class must not read as 100% attained (or 0%)."""
        reg = registry if registry is not None else self.metrics
        if reg is None:
            return
        now = self._now()
        snap = self.snapshot(now)
        for cname, objs in snap.items():
            for oname, entry in objs.items():
                labels = {"class": cname, "objective": oname}
                for w in ("fast", "slow"):
                    win = entry[w]
                    if win["attainment"] is None:
                        continue
                    reg.set_gauge("app_slo_attainment", win["attainment"],
                                  window=w, **labels)
                    if win["burn_rate"] is not None:
                        reg.set_gauge("app_slo_burn_rate", win["burn_rate"],
                                      window=w, **labels)
                if entry["budget_remaining"] is not None:
                    reg.set_gauge("app_slo_budget_remaining",
                                  entry["budget_remaining"], **labels)

    # -- breach notification ---------------------------------------------------

    # -- breach notification ---------------------------------------------------

    def add_breach_listener(self, fn: Callable[[list[dict]], Any]) -> None:
        """Register a callback invoked (outside the lock, on the observing
        thread) with the current breach list, at most once per
        ``check_interval_s`` while a breach persists."""
        self._listeners.append(fn)

    def _maybe_check(self, now: float) -> None:
        if not self._listeners:
            return
        with self._lock:
            if now - self._last_check < self.check_interval_s:
                return
            self._last_check = now
        br = self.breaches(now)
        if not br:
            return
        for fn in list(self._listeners):
            try:
                fn(br)
            except Exception as e:  # noqa: BLE001 - a listener must not poison the record path
                if self.logger is not None:
                    self.logger.warnf("slo breach listener failed: %r", e)


class CaptureWatcher:
    """Trigger-fired anomaly capture (slo.py:434-625): on a burn-rate
    breach, write the flight recorder rings, the engines' health, perf and
    quality snapshots and the SLO state to a timestamped bundle directory.

    Token-bucket rate-limited: ``burst`` captures up front, one refilled
    every ``min_interval_s``. Old bundles are swept past ``max_bundles``.
    Off unless the app opts in (``SLO_CAPTURE=true``); both clocks are
    injectable for tests."""

    def __init__(self, container, slo: SLOEngine, *, out_dir: str,
                 min_interval_s: float = 600.0, burst: int = 1,
                 trace_s: float = 0.0, flight_requests: int = 64,
                 flight_steps: int = 128, max_bundles: int = 32,
                 now: Callable[[], float] = time.monotonic,
                 clock: Callable[[], float] = time.time):
        self.container = container
        self.slo = slo
        self.out_dir = out_dir
        self.min_interval_s = max(float(min_interval_s), 1e-9)
        self.burst = max(1, int(burst))
        self.trace_s = float(trace_s)
        self.flight_requests = int(flight_requests)
        self.flight_steps = int(flight_steps)
        # bundles kept on disk (0 = unbounded): the bucket bounds them per
        # interval, this across days
        self.max_bundles = int(max_bundles)
        self._now = now
        self._clock = clock
        self._tokens = float(self.burst)
        self._refill_at = now()
        self._seq = 0
        self._tracing = False
        self._trace_thread: threading.Thread | None = None
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, config, container, slo: SLOEngine, **kw: Any) -> "CaptureWatcher":
        out_dir = config.get_or_default(
            "SLO_CAPTURE_DIR", config.get_or_default("PROFILER_DIR", "/tmp/gofr_tpu_profile"))
        return cls(
            container, slo, out_dir=out_dir,
            min_interval_s=config.get_float("SLO_CAPTURE_MIN_INTERVAL_S", 600.0),
            burst=config.get_int("SLO_CAPTURE_BURST", 1),
            trace_s=config.get_float("SLO_CAPTURE_TRACE_S", 0.0),
            max_bundles=config.get_int("SLO_CAPTURE_MAX_BUNDLES", 32), **kw)

    # -- token bucket ----------------------------------------------------------

    def _acquire(self) -> bool:
        with self._lock:
            now = self._now()
            self._tokens = min(float(self.burst),
                               self._tokens + (now - self._refill_at) / self.min_interval_s)
            self._refill_at = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    # -- the capture -----------------------------------------------------------

    def on_breach(self, breaches: list[dict]) -> str | None:
        """The breach listener: write one bundle if the bucket has a token,
        else count the suppression. Returns the bundle's directory (None
        when rate-limited or the write failed)."""
        metrics = getattr(self.container, "metrics", None)
        logger = getattr(self.container, "logger", None)
        if not self._acquire():
            if metrics is not None:
                metrics.increment_counter("app_slo_captures_suppressed_total", 1)
            return None
        try:
            path = self._write_bundle(breaches)
        except Exception as e:  # noqa: BLE001 - capture is best-effort diagnostics
            if logger is not None:
                logger.warnf("slo anomaly capture failed: %r", e)
            return None
        if metrics is not None:
            metrics.increment_counter("app_slo_captures_total", 1)
        if self.trace_s > 0:
            self._start_trace(path)
        if logger is not None:
            logger.warnf("slo burn breach: anomaly bundle written to %s (%d objectives burning)",
                         path, len(breaches))
        return path

    def _write_bundle(self, breaches: list[dict]) -> str:
        with self._lock:
            self._seq += 1
            seq = self._seq
        stamp = time.strftime("%Y%m%d-%H%M%S", time.localtime(self._clock()))
        path = os.path.join(self.out_dir, f"slo-capture-{stamp}-{seq:03d}")
        os.makedirs(path, exist_ok=True)
        flight = getattr(self.container, "flight", None)
        served = getattr(self.container, "engines", {})
        engines = {}
        for name, engine in served.items():
            try:
                engines[name] = engine.health_check() if hasattr(engine, "health_check") else {}
            except Exception as e:  # noqa: BLE001 - a broken probe is itself evidence
                engines[name] = {"status": "DOWN", "error": repr(e)}
        perf = None
        try:
            # the roofline state at the breach: was the card starved or full?
            planes = {name: e.perf.snapshot(time.monotonic()) for name, e in served.items()
                      if getattr(e, "perf", None) is not None}
            perf_fn = getattr(self.container, "perf_totals", None)
            totals = perf_fn() if callable(perf_fn) else None
            if planes or totals:
                perf = {"engines": planes, "totals": totals}
        except Exception:  # noqa: BLE001 - capture is best-effort diagnostics
            perf = None
        quality = {}
        for name, e in served.items():
            # each engine's shadow samples with their replay payloads
            try:
                snap_fn = getattr(e, "quality_snapshot", None)
                snap = snap_fn() if callable(snap_fn) else None
            except Exception:  # noqa: BLE001 - capture is best-effort diagnostics
                snap = None
            if snap is not None:
                quality[name] = snap
        bundle = {
            "ts": self._clock(),
            "reason": breaches,
            "slo": self.slo.snapshot(),
            "flight": {
                "requests": flight.requests(self.flight_requests) if flight is not None else [],
                "steps": flight.steps(self.flight_steps) if flight is not None else [],
            },
            "engines": engines,
            "perf": perf,
        }
        if quality:
            bundle["quality"] = quality
        with open(os.path.join(path, "bundle.json"), "w") as f:
            json.dump(bundle, f, indent=1, default=str)
        self._sweep()
        return path

    def _sweep(self) -> None:
        """Drop the oldest ``slo-capture-*`` directories past
        ``max_bundles`` (their stamp-and-sequence names sort by age)."""
        if self.max_bundles <= 0:
            return
        try:
            names = sorted(d for d in os.listdir(self.out_dir) if d.startswith("slo-capture-"))
        except OSError:
            return
        for name in names[:-self.max_bundles]:
            shutil.rmtree(os.path.join(self.out_dir, name), ignore_errors=True)

    def _start_trace(self, path: str) -> None:
        """``trace_s`` seconds of ``torch.profiler`` on a thread of its own
        (the breach was seen on a latency-critical path), exported as a
        Chrome trace to ``<bundle>/trace/trace.json``. One trace at a
        time."""
        with self._lock:
            if self._tracing:
                return
            self._tracing = True

        def run() -> None:
            try:
                record_trace(os.path.join(path, "trace"), self.trace_s)
            except Exception as e:  # noqa: BLE001 - diagnostics only
                logger = getattr(self.container, "logger", None)
                if logger is not None:
                    logger.warnf("slo capture trace failed: %r", e)
            finally:
                with self._lock:
                    self._tracing = False

        self._trace_thread = threading.Thread(target=run, daemon=True,
                                              name="gofr-slo-capture-trace")
        self._trace_thread.start()


def record_trace(out_dir: str, seconds: float) -> str:
    """Record ``seconds`` of the process with ``torch.profiler`` and export
    a Chrome trace to ``out_dir/trace.json``; returns its path. On a card
    the profiler takes CUDA activity, every kernel the process launches
    from any thread; the window ends once the card has run what was
    launched in it. Without a card it takes CPU activity. The SLO capture
    trace and ``/debug/profile`` both record with it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        time.sleep(seconds)
        if on_card:
            torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(trace)
    return trace
