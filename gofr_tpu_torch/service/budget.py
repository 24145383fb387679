"""Envoy-style shared retry budget: retries are a *fraction of live
traffic*, never an independent knob.

A fixed per-request retry count amplifies: when a dependency browns out
and every caller retries 3 times, the dependency sees 4x its capacity
and stays down. A budget caps the *aggregate*: retries inside a sliding
window may not exceed ``fraction`` of the original requests seen in the
same window (with a ``min_retries`` floor so a near-idle client can
still retry at all). When the budget is spent, callers fail fast with
the last error — the storm decays instead of feeding itself.

One instance is shared by everything that re-sends work: the
``service.Retry`` middleware spends a token per retry attempt (in the
JAX package the router also spends one per spill-on-5xx and per hedge;
the port has no router yet). Thread-safe; the clock is injectable for tests.

The port's own copy of gofr_tpu/service/budget.py.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable


class RetryBudget:
    """Sliding-window retry budget (see module docstring).

    ``note_request()`` records an original request; ``try_spend()``
    asks for one retry/hedge token and answers whether the caller may
    re-send. Metrics (optional): ``app_retry_budget_spent_total`` and
    ``app_retry_budget_exhausted_total``.
    """

    def __init__(self, fraction: float = 0.2, min_retries: int = 3,
                 window_s: float = 10.0, *, metrics: Any = None,
                 clock: Callable[[], float] = time.monotonic):
        self.fraction = float(fraction)
        self.min_retries = int(min_retries)
        self.window_s = float(window_s)
        self._metrics = metrics
        self._clock = clock
        self._reqs: deque[float] = deque()
        self._retries: deque[float] = deque()
        self._lock = threading.Lock()

    def _prune(self, now: float) -> None:
        cut = now - self.window_s
        while self._reqs and self._reqs[0] < cut:
            self._reqs.popleft()
        while self._retries and self._retries[0] < cut:
            self._retries.popleft()

    def note_request(self) -> None:
        """Record one ORIGINAL request (not a retry) in the window."""
        now = self._clock()
        with self._lock:
            self._prune(now)
            self._reqs.append(now)

    def allowed(self) -> int:
        """Current retry allowance for the window."""
        now = self._clock()
        with self._lock:
            self._prune(now)
            return max(self.min_retries, int(len(self._reqs) * self.fraction))

    def try_spend(self) -> bool:
        """Take one retry token. False = budget exhausted: do NOT re-send."""
        now = self._clock()
        with self._lock:
            self._prune(now)
            cap = max(self.min_retries, int(len(self._reqs) * self.fraction))
            if len(self._retries) >= cap:
                ok = False
            else:
                self._retries.append(now)
                ok = True
        if self._metrics is not None:
            if ok:
                self._metrics.increment_counter("app_retry_budget_spent_total")
            else:
                self._metrics.increment_counter("app_retry_budget_exhausted_total")
        return ok

    def snapshot(self) -> dict:
        now = self._clock()
        with self._lock:
            self._prune(now)
            return {
                "window_requests": len(self._reqs),
                "window_retries": len(self._retries),
                "allowed": max(self.min_retries,
                               int(len(self._reqs) * self.fraction)),
                "fraction": self.fraction,
            }

    @classmethod
    def from_config(cls, config: Any, metrics: Any = None) -> "RetryBudget":
        """RETRY_BUDGET_FRACTION / RETRY_BUDGET_MIN / RETRY_BUDGET_WINDOW_S
        (docs/configs.md)."""
        return cls(
            fraction=config.get_float("RETRY_BUDGET_FRACTION", 0.2),
            min_retries=config.get_int("RETRY_BUDGET_MIN", 3),
            window_s=config.get_float("RETRY_BUDGET_WINDOW_S", 10.0),
            metrics=metrics,
        )
