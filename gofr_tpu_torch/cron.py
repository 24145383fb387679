"""Cron scheduler: 5-field crontab with per-firing tracing.

Parity with gofr `pkg/gofr/cron.go`: schedules are ``min hour dom month dow``
supporting ``*``, ``*/n``, ranges ``a-b`` (with step), and lists ``a,b,c``
(parser semantics of `cron.go:86-224`); a minute ticker walks the job table
(`cron.go:226-240`); every firing runs concurrently with a fresh root span and a
no-op-request Context (`cron.go:252-262,332-356`).

The port's own copy of gofr_tpu/cron.py. ``App.add_cron_job`` registers a
job, ``App.arun`` starts the table and ``App.stop`` stops it; a job that
fails is logged and the table goes on.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

FIELD_RANGES = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 6))
FIELD_NAMES = ("minute", "hour", "day-of-month", "month", "day-of-week")


class CronParseError(ValueError):
    pass


def _parse_field(spec: str, lo: int, hi: int, name: str) -> frozenset[int]:
    values: set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            raise CronParseError(f"empty {name} field entry")
        step = 1
        if "/" in part:
            part, _, step_s = part.partition("/")
            try:
                step = int(step_s)
            except ValueError as e:
                raise CronParseError(f"bad step in {name} field: {step_s!r}") from e
            if step <= 0:
                raise CronParseError(f"step must be positive in {name} field")
        if part == "*":
            start, end = lo, hi
        elif "-" in part:
            a, _, b = part.partition("-")
            try:
                start, end = int(a), int(b)
            except ValueError as e:
                raise CronParseError(f"bad range in {name} field: {part!r}") from e
        else:
            try:
                start = end = int(part)
            except ValueError as e:
                raise CronParseError(f"bad value in {name} field: {part!r}") from e
        if start < lo or end > hi or start > end:
            raise CronParseError(f"{name} value out of range [{lo},{hi}]: {part!r}")
        values.update(range(start, end + 1, step))
    return frozenset(values)


@dataclass(frozen=True)
class Schedule:
    minutes: frozenset[int]
    hours: frozenset[int]
    days: frozenset[int]
    months: frozenset[int]
    weekdays: frozenset[int]
    # Vixie-cron day rule: when BOTH day-of-month and day-of-week are
    # restricted (field doesn't start with "*"), a day matching EITHER fires.
    days_restricted: bool = True
    weekdays_restricted: bool = True

    @classmethod
    def parse(cls, spec: str) -> "Schedule":
        fields = spec.split()
        if len(fields) != 5:
            raise CronParseError(f"schedule must have 5 fields, got {len(fields)}: {spec!r}")
        parsed = [
            _parse_field(f, lo, hi, name)
            for f, (lo, hi), name in zip(fields, FIELD_RANGES, FIELD_NAMES)
        ]
        return cls(
            *parsed,
            days_restricted=not fields[2].startswith("*"),
            weekdays_restricted=not fields[4].startswith("*"),
        )

    def matches(self, t: time.struct_time) -> bool:
        # dow: python tm_wday Mon=0..Sun=6; cron uses Sun=0..Sat=6
        cron_dow = (t.tm_wday + 1) % 7
        dom_ok = t.tm_mday in self.days
        dow_ok = cron_dow in self.weekdays
        day_ok = (
            (dom_ok or dow_ok)
            if (self.days_restricted and self.weekdays_restricted)
            else (dom_ok and dow_ok)
        )
        return (
            t.tm_min in self.minutes
            and t.tm_hour in self.hours
            and t.tm_mon in self.months
            and day_ok
        )


@dataclass
class Job:
    name: str
    schedule: Schedule
    fn: Callable[..., Any]
    last_fired_minute: int = -1


class Crontab:
    """Minute-resolution scheduler; each firing runs in its own thread with a
    fresh root span and a no-op-request Context."""

    def __init__(self, container, tick_seconds: float = 20.0):
        self._container = container
        self._jobs: list[Job] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._tick_seconds = tick_seconds

    def add_job(self, spec: str, name: str, fn: Callable[..., Any]) -> None:
        schedule = Schedule.parse(spec)
        with self._lock:
            self._jobs.append(Job(name or fn.__name__, schedule, fn))

    @property
    def jobs(self) -> list[Job]:
        with self._lock:
            return list(self._jobs)

    def start(self) -> None:
        if not self.jobs:
            return
        self._thread = threading.Thread(target=self._run, name="gofr-cron", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._tick_seconds):
            self.tick(time.time())

    def tick(self, now: float) -> list[str]:
        """Fire all jobs matching the minute containing ``now``; at most once
        per minute per job. Returns names fired (for tests)."""
        t = time.localtime(now)
        minute_id = int(now // 60)
        fired = []
        with self._lock:
            jobs = list(self._jobs)
        for job in jobs:
            if job.last_fired_minute == minute_id:
                continue
            if job.schedule.matches(t):
                job.last_fired_minute = minute_id
                fired.append(job.name)
                threading.Thread(target=self._fire, args=(job,), name=f"cron-{job.name}", daemon=True).start()
        return fired

    def _fire(self, job: Job) -> None:
        from gofr_tpu_torch.context import Context
        from gofr_tpu_torch.http.request import Request

        span = self._container.tracer.start_span(f"cron {job.name}", set_current=False)
        ctx = Context(Request(), self._container, span=span)
        try:
            job.fn(ctx)
            span.set_status("OK")
        except Exception as e:  # noqa: BLE001 - panic recovery per firing
            span.set_status("ERROR")
            self._container.logger.errorf("cron job %s failed: %r", job.name, e)
        finally:
            span.finish()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
