"""Priority scheduling (QoS tier 2): the engine's queue, QoS-aware (the
port's own copy of gofr_tpu/qos/scheduler.py).

``QoSQueue`` is a drop-in replacement for the FIFO ``queue.Queue`` the
engine drains (``GenerateEngine._queue``): same ``put/get/get_nowait/qsize``
surface, same blocking/timeout/Empty semantics (it subclasses
``queue.Queue`` and overrides only the storage hooks, so all locking and
condition-variable behavior is literally the stdlib's).

Two modes:

- **FIFO (default, QoS off)** — storage is the same ``collections.deque``
  ``queue.Queue`` uses; behavior is byte-for-byte a plain queue's, so the
  engine and its EDF prefill planner (``gpu/planner.py``) see no change.
- **Priority (after ``set_policy``)** — one EDF heap per priority class
  (ordered by ``(deadline, arrival)``; no deadline sorts last so deadline
  traffic overtakes best-effort inside its class), scheduled across
  classes by *weighted fair credits*: every replenish cycle grants each
  class ``weight`` credits, and ``get`` serves the highest-priority
  funded non-empty class. Under saturation classes drain in weight
  proportion (e.g. interactive:default:batch = 8:4:1) while idle classes
  never block others and no class starves.

Items are duck-typed: a priority class rides on ``item.kw["_qos_class"]``
and the deadline on ``item.deadline`` (the engine ``Request`` shape);
anything else lands in the default class as best-effort.
"""

from __future__ import annotations

import collections
import heapq
import itertools
import math
import queue
import time
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from gofr_tpu_torch.qos import QoSPolicy


class QoSQueue(queue.Queue):
    def __init__(self, policy: "QoSPolicy | None" = None, metrics=None):
        super().__init__()  # calls _init
        if policy is not None:
            self.set_policy(policy, metrics=metrics)

    # -- queue.Queue storage hooks (called under self.mutex) -------------------

    def _init(self, maxsize: int) -> None:
        self.queue: collections.deque = collections.deque()  # FIFO-mode storage
        self._policy: "QoSPolicy | None" = None
        self._metrics = None
        self._heaps: dict[str, list] = {}
        self._credits: dict[str, float] = {}
        self._seq = itertools.count()

    def _qsize(self) -> int:
        if self._policy is None:
            return len(self.queue)
        return sum(len(h) for h in self._heaps.values())

    def _put(self, item) -> None:
        if self._policy is None:
            self.queue.append(item)
        else:
            self._route(item)

    def _get(self):
        if self._policy is None:
            return self.queue.popleft()
        item = self._pick()
        if self._metrics is not None:
            enq = getattr(item, "enqueued_at", None)
            if enq is not None:
                cls = self._policy.resolve(getattr(item, "kw", {}).get("_qos_class"))
                self._metrics.record_histogram(
                    "app_qos_queue_wait_seconds", time.monotonic() - enq,
                    qos_class=cls.name,
                )
        return item

    # -- QoS mode --------------------------------------------------------------

    def set_policy(self, policy: "QoSPolicy", metrics=None) -> None:
        """Flip FIFO → priority scheduling, or swap policies. ALL queued
        work is re-routed under the new policy — the FIFO deque on first
        enable, and the old class heaps when a controller re-registers
        (dropping heap backlog would strand accepted requests until their
        callers time out)."""
        with self.mutex:
            backlog = list(self.queue)
            self.queue.clear()
            for heap in self._heaps.values():
                backlog.extend(entry[2] for entry in sorted(heap))
            self._policy = policy
            self._metrics = metrics
            self._heaps = {c.name: [] for c in policy.classes}
            self._credits = {c.name: float(c.weight) for c in policy.classes}
            for item in backlog:
                self._route(item)

    def _route(self, item) -> None:
        cls = self._policy.resolve(getattr(item, "kw", {}).get("_qos_class"))
        deadline = getattr(item, "deadline", None)
        key = deadline if deadline is not None else math.inf
        heapq.heappush(self._heaps[cls.name], (key, next(self._seq), item))

    def _pick(self):
        # policy.classes is rank-ordered (interactive first): among funded
        # non-empty classes the highest priority wins; when every waiting
        # class is out of credit, replenish all by weight — one cycle hands
        # out `weight` turns per class, which is the fairness guarantee.
        nonempty = [c for c in self._policy.classes if self._heaps[c.name]]
        funded = [c for c in nonempty if self._credits[c.name] >= 1.0]
        if not funded:
            for c in self._policy.classes:
                self._credits[c.name] = min(
                    self._credits[c.name] + c.weight, 2.0 * c.weight)
            funded = [c for c in nonempty if self._credits[c.name] >= 1.0] or nonempty
        cls = funded[0]
        self._credits[cls.name] -= 1.0
        return heapq.heappop(self._heaps[cls.name])[2]

    def wait_nonempty(self, timeout: float) -> bool:
        """Block until the queue is non-empty (or timeout), WITHOUT
        consuming — the engine's idle poke. A get/put round trip here
        would record a spurious queue-wait sample and debit a fairness
        credit per idle loop iteration."""
        with self.not_empty:
            if not self._qsize():
                self.not_empty.wait(timeout)
            return bool(self._qsize())

    def depths(self) -> dict[str, int]:
        """Per-class backlog snapshot (the ``app_qos_queue_depth`` gauge);
        empty in FIFO mode."""
        with self.mutex:
            if self._policy is None:
                return {}
            return {name: len(h) for name, h in self._heaps.items()}
