"""SLO engine: per-QoS-class objectives, rolling attainment, error budgets
(the port's own copy of gofr_tpu/metrics/slo.py, its ``CaptureWatcher``
left for the quality plane's slice).

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
class burns). The JAX engine's breach listeners (its capture watcher's
hook, ``SLO_CHECK_INTERVAL_S``) come with that watcher.

Feed points: the engine's device loop / completion path (gpu/engine.py
``_mark_first_token`` → ttft, ``_maybe_finish`` → tpot, ``_observe_done`` →
e2e + availability) — the exact callsites that record the raw histograms,
so the two views can never disagree about what was measured.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["Objective", "SLOEngine", "SLOTracker"]

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
    flips health to DEGRADED on sustained fast-window burn. Thread-safe;
    ``now`` is injectable for tests."""

    def __init__(self, objectives: list[Objective], *, metrics=None,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 3600.0, burn_threshold: float = 10.0,
                 min_samples: int = 10,
                 default_class: str = "default",
                 rank: dict[str, int] | None = None,
                 now: Callable[[], float] = time.monotonic):
        self.metrics = metrics
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

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_config(cls, config, *, metrics=None,
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
            # quality objective: the JAX package's shadow scorer feeds it,
            # which comes with the quality plane (ROADMAP.md Queue A 5b);
            # declared here so the objective set is the JAX engine's for
            # the same config. Default 0 = off.
            quality = config.get_float(f"SLO_{up}_QUALITY", 0.0)
            if 0.0 < quality < 1.0:
                objectives.append(Objective(name, "quality", quality))
        return cls(
            objectives, metrics=metrics,
            fast_window_s=config.get_float("SLO_FAST_WINDOW_S", 60.0),
            slow_window_s=config.get_float("SLO_SLOW_WINDOW_S", 3600.0),
            burn_threshold=config.get_float("SLO_BURN_THRESHOLD", 10.0),
            min_samples=config.get_int("SLO_MIN_SAMPLES", 10),
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

    def observe_outcome(self, cls_name: str | None, ok: bool) -> None:
        """One availability sample: did the request complete without error
        (timeouts, sheds, and engine faults all count against budget)."""
        tr = self._trackers.get((self._canon(cls_name), "availability"))
        if tr is None:
            return
        now = self._now()
        with self._lock:
            tr.observe(bool(ok), now)

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
