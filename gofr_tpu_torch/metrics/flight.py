"""Flight recorder: always-on ring buffers of recent serving activity (the
port's own copy of gofr_tpu/metrics/flight.py).

Metrics aggregate and traces need a backend attached *before* the incident
— this is the third leg: the engine appends every completed request's
timeline (queue wait, TTFT, TPOT, e2e, slot, preemptions, trace id) and
every device step (kind, wall time, occupancy, signature) into two bounded
deques (``FLIGHT_REQUESTS``, ``FLIGHT_STEPS``), so ``GET /debug/requests``
/ ``GET /debug/engine`` can answer "what just happened" on a production
box with nothing but curl. A third ring (128 deep) keeps the
online step controller's decisions for ``GET /debug/control``, and every
step entry carries the knob vector it ran under.

Cost discipline: one uncontended lock acquisition + a dict append per
completed request / device step — never per token. The lock exists only
because ``list(deque)`` raises if another thread appends mid-iteration;
appends themselves are O(1) with bounded memory (maxlen evicts oldest).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any


class FlightRecorder:
    def __init__(self, max_requests: int = 256, max_steps: int = 512,
                 max_controls: int = 128):
        self._requests: collections.deque[dict[str, Any]] = collections.deque(
            maxlen=max(1, int(max_requests)))
        self._steps: collections.deque[dict[str, Any]] = collections.deque(
            maxlen=max(1, int(max_steps)))
        self._controls: collections.deque[dict[str, Any]] = collections.deque(
            maxlen=max(1, int(max_controls)))
        self._lock = threading.Lock()

    # -- recording (engine side) -----------------------------------------------

    def record_request(self, entry: dict[str, Any]) -> None:
        with self._lock:
            self._requests.append(entry)

    def record_step(self, kind: str, seconds: float, occupancy: float,
                    signature: Any, backlog: int = 0, inflight: int = 0,
                    device_s: float | None = None, bytes_: float | None = None,
                    flops: float | None = None,
                    bubble_s: float | None = None,
                    knobs: dict[str, Any] | None = None) -> None:
        # Steps are recorded at COMPLETION (fold) time; `seconds` spans
        # dispatch→fold and `inflight` is the in-flight queue depth left
        # after this entry was taken off it — 0 on every step means the
        # pipeline is running synchronously. The perf plane
        # (metrics/perf.py) adds the roofline view per step: `device_s` is
        # overlap-deduplicated device-queue residency, `bytes`/`flops` the
        # analytical cost from the step's actual shapes, `bubble` the
        # device-idle-while-work-queued gap in front.
        entry = {
            "at": time.time(),
            "kind": kind,
            "seconds": round(float(seconds), 6),
            "occupancy": round(float(occupancy), 4),
            "signature": str(signature),
            "backlog": int(backlog),
            "inflight": int(inflight),
        }
        if device_s is not None:
            entry["device_s"] = round(float(device_s), 6)
            entry["bytes"] = float(bytes_ or 0.0)
            entry["flops"] = float(flops or 0.0)
            entry["bubble"] = round(float(bubble_s or 0.0), 6)
        if knobs:
            entry["knobs"] = dict(knobs)
        with self._lock:
            self._steps.append(entry)

    def record_control(self, decision: dict[str, Any]) -> None:
        """One controller decision (already to_dict()-flattened)."""
        with self._lock:
            self._controls.append(decision)

    # -- inspection (debug endpoints / tests) ----------------------------------

    def requests(self, limit: int | None = None) -> list[dict[str, Any]]:
        """Completed request timelines, newest first."""
        with self._lock:
            out = list(self._requests)
        out.reverse()
        return out[:limit] if limit else out

    def steps(self, limit: int | None = None) -> list[dict[str, Any]]:
        """Device steps, newest first."""
        with self._lock:
            out = list(self._steps)
        out.reverse()
        return out[:limit] if limit else out

    def controls(self, limit: int | None = None) -> list[dict[str, Any]]:
        """Controller decisions, newest first."""
        with self._lock:
            out = list(self._controls)
        out.reverse()
        return out[:limit] if limit else out
