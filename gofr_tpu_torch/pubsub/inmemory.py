"""In-memory pub/sub broker: consumer groups, offsets, at-least-once redelivery.

The in-tree broker (and the hermetic test double, like the reference's
MockPubSub — but functional): per-topic append-only log, per-(topic, group)
committed offset, blocking subscribe with timeout, uncommitted messages are
redelivered — faithful at-least-once semantics so micro-batch commit logic can
be tested without Kafka.

The port's own copy of gofr_tpu/pubsub/inmemory.py.
"""

from __future__ import annotations

import threading
from typing import Any

from gofr_tpu_torch.pubsub import Message, encode_payload


class InMemoryBroker:
    def __init__(self):
        # log entries are (payload bytes, headers-or-None): headers carry
        # cross-cutting metadata like the W3C traceparent alongside the value
        self._logs: dict[str, list[tuple[bytes, dict | None]]] = {}
        self._offsets: dict[tuple[str, str], int] = {}  # committed offset
        self._cursor: dict[tuple[str, str], int] = {}  # next delivery position
        # out-of-order commits (concurrent consumer workers): positions
        # committed ahead of the contiguous prefix wait here
        self._done: dict[tuple[str, str], set[int]] = {}
        self._cond = threading.Condition()
        self._closed = False

    def publish(self, topic: str, payload: Any, headers: dict | None = None) -> None:
        data = encode_payload(payload)
        with self._cond:
            if self._closed:
                raise RuntimeError("broker closed")
            self._logs.setdefault(topic, []).append((data, dict(headers) if headers else None))
            self._cond.notify_all()

    def subscribe(self, topic: str, group: str = "default", timeout: float | None = None) -> Message | None:
        key = (topic, group)
        with self._cond:
            while True:
                if self._closed:
                    return None
                log = self._logs.setdefault(topic, [])
                pos = self._cursor.get(key, self._offsets.get(key, 0))
                if pos < len(log):
                    self._cursor[key] = pos + 1
                    value, headers = log[pos]
                    # reserved delivery keys win over publisher headers — a
                    # hostile 'offset'/'group' header must not clobber them
                    metadata = dict(headers) if headers else {}
                    metadata.update({"offset": pos, "group": group})
                    return Message(
                        topic,
                        value,
                        metadata=metadata,
                        committer=lambda p=pos: self._commit(key, p),
                    )
                if not self._cond.wait(timeout=timeout):
                    return None

    def _commit(self, key: tuple[str, str], pos: int) -> None:
        """Advance the committed offset only across a CONTIGUOUS prefix of
        committed positions. With concurrent workers (SUBSCRIBER_WORKERS),
        a fast worker's higher commit must not acknowledge a slower
        worker's still-uncommitted (possibly failed) message — the group
        offset stays at the first gap, so a crash/rewind redelivers it
        (at-least-once; matches per-partition Kafka semantics)."""
        with self._cond:
            done = self._done.setdefault(key, set())
            done.add(pos)
            offset = self._offsets.get(key, 0)
            while offset in done:
                done.discard(offset)
                offset += 1
            self._offsets[key] = offset

    def rewind_uncommitted(self, topic: str, group: str = "default") -> None:
        """Redeliver messages consumed but never committed (crash simulation)."""
        key = (topic, group)
        with self._cond:
            self._cursor[key] = self._offsets.get(key, 0)
            self._cond.notify_all()

    def create_topic(self, topic: str) -> None:
        with self._cond:
            self._logs.setdefault(topic, [])

    def delete_topic(self, topic: str) -> None:
        with self._cond:
            self._logs.pop(topic, None)

    def topics(self) -> list[str]:
        with self._cond:
            return sorted(self._logs)

    def health_check(self) -> dict[str, Any]:
        with self._cond:
            return {
                "status": "UP" if not self._closed else "DOWN",
                "details": {"backend": "inmemory", "topics": len(self._logs)},
            }

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
