"""Metrics: name-keyed registry with Prometheus text exposition (the port's
own copy of the ``Registry`` part of gofr_tpu/metrics/__init__.py).

Capability parity with the reference's metrics manager (gofr `pkg/gofr/metrics/`):
counter / up-down counter / histogram / settable gauge registered by name
(`store.go:7-34`, `register.go:41-46`), label-cardinality warning past 20 distinct
label sets (`register.go:249-268`), and a Prometheus exposition endpoint served on
a dedicated port (`exporters/exporter.go:14-29`) that also samples process runtime
gauges per scrape (`handler.go:22-35`). The flight recorder
(``metrics/flight.py``), the SLO plane (``metrics/slo.py``), the perf
plane (``metrics/perf.py``) and the quality plane (``metrics/quality.py``)
sit beside it; fleet federation waits for the fleet (ROADMAP.md Queue A 9).
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Callable, Iterable, Mapping, Sequence

LabelSet = tuple[tuple[str, str], ...]

DEFAULT_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_CARDINALITY_WARN = 20


def _labelset(labels: Mapping[str, str] | None) -> LabelSet:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(ls: LabelSet, extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in ls]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str):
        self.name = name
        self.description = description
        self._lock = threading.Lock()
        self._warned = False

    def expose(self) -> Iterable[str]:  # pragma: no cover - abstract
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, description: str):
        super().__init__(name, description)
        self._values: dict[LabelSet, float] = {}

    def inc(self, value: float = 1.0, **labels: str) -> None:
        ls = _labelset(labels)
        with self._lock:
            self._values[ls] = self._values.get(ls, 0.0) + value

    def expose(self) -> Iterable[str]:
        with self._lock:
            items = list(self._values.items())
        for ls, v in items or [((), 0.0)]:
            yield f"{self.name}{_fmt_labels(ls)} {_fmt_value(v)}"

    @property
    def label_cardinality(self) -> int:
        return len(self._values)

    def value(self, **labels: str) -> float:
        return self._values.get(_labelset(labels), 0.0)


class Gauge(_Metric):
    """Settable gauge (the reference emulates this over async OTel gauges;
    a plain settable value is the natural design here)."""

    kind = "gauge"

    def __init__(self, name: str, description: str):
        super().__init__(name, description)
        self._values: dict[LabelSet, float] = {}

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_labelset(labels)] = float(value)

    def expose(self) -> Iterable[str]:
        with self._lock:
            items = list(self._values.items())
        for ls, v in items or [((), 0.0)]:
            yield f"{self.name}{_fmt_labels(ls)} {_fmt_value(v)}"

    @property
    def label_cardinality(self) -> int:
        return len(self._values)

    def value(self, **labels: str) -> float:
        return self._values.get(_labelset(labels), 0.0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str, buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, description)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[LabelSet, list[int]] = {}
        self._sums: dict[LabelSet, float] = {}
        self._totals: dict[LabelSet, int] = {}

    def observe(self, value: float, **labels: str) -> None:
        ls = _labelset(labels)
        with self._lock:
            counts = self._counts.setdefault(ls, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            self._sums[ls] = self._sums.get(ls, 0.0) + value
            self._totals[ls] = self._totals.get(ls, 0) + 1

    def expose(self) -> Iterable[str]:
        with self._lock:
            items = [(ls, list(c), self._sums[ls], self._totals[ls]) for ls, c in self._counts.items()]
        for ls, counts, total_sum, total in items:
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                le = 'le="' + _fmt_value(b) + '"'
                yield f"{self.name}_bucket{_fmt_labels(ls, le)} {cum}"
            inf = 'le="+Inf"'
            yield f"{self.name}_bucket{_fmt_labels(ls, inf)} {total}"
            yield f"{self.name}_sum{_fmt_labels(ls)} {_fmt_value(total_sum)}"
            yield f"{self.name}_count{_fmt_labels(ls)} {total}"

    @property
    def label_cardinality(self) -> int:
        return len(self._totals)

    def count(self, **labels: str) -> int:
        return self._totals.get(_labelset(labels), 0)

    def sum(self, **labels: str) -> float:
        return self._sums.get(_labelset(labels), 0.0)


class Registry:
    """Name-keyed metric store with exposition (gofr `metrics/store.go`)."""

    def __init__(self, logger=None):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self._logger = logger
        self._collect_hooks: list[Callable[["Registry"], None]] = []

    # -- registration ----------------------------------------------------------

    def new_counter(self, name: str, description: str = "") -> Counter:
        return self._register(name, lambda: Counter(name, description), Counter)

    def new_gauge(self, name: str, description: str = "") -> Gauge:
        return self._register(name, lambda: Gauge(name, description), Gauge)

    def new_histogram(
        self, name: str, description: str = "", buckets: Sequence[float] = DEFAULT_BUCKETS
    ) -> Histogram:
        return self._register(name, lambda: Histogram(name, description, buckets), Histogram)

    def _register(self, name: str, factory, cls):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as {type(existing).__name__}"
                    )
                return existing
            metric = factory()
            self._metrics[name] = metric
            return metric

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    # -- recording by name (container-facing API, mirrors gofr Metrics iface) --

    def increment_counter(self, name: str, value: float = 1.0, **labels: str) -> None:
        m = self._metrics.get(name)
        if isinstance(m, Counter):
            m.inc(value, **labels)
            self._warn_cardinality(m)

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        m = self._metrics.get(name)
        if isinstance(m, Gauge):
            m.set(value, **labels)
            self._warn_cardinality(m)

    def record_histogram(self, name: str, value: float, **labels: str) -> None:
        m = self._metrics.get(name)
        if isinstance(m, Histogram):
            m.observe(value, **labels)
            self._warn_cardinality(m)

    def _warn_cardinality(self, m: _Metric) -> None:
        card = getattr(m, "label_cardinality", 0)
        if card > _CARDINALITY_WARN and not m._warned:
            m._warned = True
            if self._logger is not None:
                self._logger.warnf(
                    "metric %s has high label cardinality (%d > %d); consider fewer label values",
                    m.name, card, _CARDINALITY_WARN,
                )

    # -- exposition ------------------------------------------------------------

    def add_collect_hook(self, hook: Callable[["Registry"], None]) -> None:
        """Hook invoked on every scrape (runtime/HBM gauges sample here)."""
        self._collect_hooks.append(hook)

    def remove_collect_hook(self, hook: Callable[["Registry"], None]) -> None:
        """Unregister a scrape hook (no-op if absent) — replacing a
        component (e.g. re-enabling QoS) must not leave its stale sampler
        writing gauges on every scrape."""
        try:
            self._collect_hooks.remove(hook)
        except ValueError:
            pass

    def expose_text(self) -> str:
        for hook in list(self._collect_hooks):
            try:
                hook(self)
            except Exception:  # noqa: BLE001 - a bad hook must not break /metrics
                pass
        lines: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            if m.description:
                lines.append(f"# HELP {m.name} {m.description}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


def sample_runtime_metrics(registry: Registry) -> None:
    """Per-scrape process gauges (analog of gofr's memstats/goroutine sampling,
    `metrics/handler.go:22-35`)."""
    g_threads = registry.new_gauge("app_threads", "live python threads")
    g_rss = registry.new_gauge("app_sys_memory_rss_bytes", "resident set size")
    g_uptime = registry.new_gauge("app_uptime_seconds", "seconds since process start")
    g_threads.set(threading.active_count())
    g_rss.set(_rss_bytes())
    g_uptime.set(time.monotonic() - _START)


_START = time.monotonic()


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * (os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096)
    except (OSError, ValueError, IndexError):
        return 0
