"""File-transport pub/sub broker: the in-memory broker's semantics over a
shared directory, so SEPARATE PROCESSES can coordinate without Kafka.

This is the transport behind the two-process publisher/subscriber examples
(`examples/using-publisher` + `examples/using-subscriber`): a per-topic
append-only JSONL log plus a per-(topic, group) committed-offset file, all
under ``PUBSUB_DIR``. Appends are serialized with ``fcntl`` advisory locks;
offsets advance only across a contiguous committed prefix (the in-memory
broker's rule), so a consumer crash between handler and commit redelivers —
faithful at-least-once across process boundaries.

Not a Kafka replacement: one log per topic (no partitions), delivery fans
out per GROUP — run ONE consumer process per (topic, group). The delivery
cursor is process-local (only the committed offset is shared on disk), so
two same-group consumer processes would each receive every message; there
is no cross-process claim/lease protocol. Throughput is bounded by
fsync-free appends + poll-based subscribe. It exists so the example tier
and small deployments have a real cross-process broker with zero external
dependencies; production traffic and consumer scale-out belong on
``PUBSUB_BACKEND=kafka``.

The port's own copy of gofr_tpu/pubsub/file.py.
"""

from __future__ import annotations

import base64
import fcntl
import json
import os
import threading
import time
from typing import Any

from gofr_tpu_torch.pubsub import Message, encode_payload

_SAFE = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_."


def _slug(name: str) -> str:
    return "".join(c if c in _SAFE else "_" for c in name) or "_"


class FileBroker:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        # per-(topic, group) delivery cursor for THIS process; starts at the
        # durable committed offset, so a process restart redelivers exactly
        # the uncommitted suffix (at-least-once)
        self._cursor: dict[tuple[str, str], int] = {}
        self._done: dict[tuple[str, str], set[int]] = {}
        # per-topic (bytes-consumed, committed lines) read cache
        self._log_cache: dict[str, tuple[int, list[str]]] = {}
        self._closed = False

    # -- paths -----------------------------------------------------------------

    def _log_path(self, topic: str) -> str:
        return os.path.join(self.dir, f"{_slug(topic)}.log")

    def _offset_path(self, topic: str, group: str) -> str:
        return os.path.join(self.dir, f"{_slug(topic)}.{_slug(group)}.offset")

    def _read_offset(self, topic: str, group: str) -> int:
        try:
            with open(self._offset_path(topic, group)) as f:
                return int(f.read().strip() or "0")
        except (FileNotFoundError, ValueError):
            return 0

    def _write_offset(self, topic: str, group: str, offset: int) -> None:
        path = self._offset_path(topic, group)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(offset))
        os.replace(tmp, path)  # atomic: readers never see a torn offset

    # -- publish ---------------------------------------------------------------

    def publish(self, topic: str, payload: Any, headers: dict | None = None) -> None:
        if self._closed:
            raise RuntimeError("broker closed")
        record = {"p": base64.b64encode(encode_payload(payload)).decode()}
        if headers:
            record["h"] = dict(headers)
        line = json.dumps(record, separators=(",", ":")) + "\n"
        with open(self._log_path(topic), "a") as f:
            # advisory lock serializes concurrent publishers: one record is
            # one line, and interleaved partial writes would corrupt both
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                f.write(line)
                f.flush()
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    # -- subscribe -------------------------------------------------------------

    def _read_log(self, topic: str) -> list[str]:
        path = self._log_path(topic)
        try:
            size = os.stat(path).st_size
        except FileNotFoundError:
            return []
        # append-only log: unchanged size means unchanged content, so idle
        # polls are one stat, not a full re-read (delete_topic shrinks the
        # size, which also invalidates here)
        cached = self._log_cache.get(topic)
        if cached is not None and cached[0] == size:
            return cached[1]
        with open(path) as f:
            data = f.read()
        # only newline-TERMINATED lines are committed records: a publisher
        # in another process may be mid-append, and delivering the torn
        # tail would hand the handler truncated bytes (and a commit would
        # then skip the real message once the write completes)
        end = data.rfind("\n") + 1
        lines = data[:end].splitlines()
        self._log_cache[topic] = (size if end == len(data) else end, lines)
        return lines

    def subscribe(self, topic: str, group: str = "default",
                  timeout: float | None = None) -> Message | None:
        key = (topic, _slug(group))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._closed:
                return None
            with self._lock:
                pos = self._cursor.get(key)
                if pos is None:
                    pos = self._cursor[key] = self._read_offset(topic, group)
                lines = self._read_log(topic)
                if pos < len(lines):
                    self._cursor[key] = pos + 1
                    try:
                        record = json.loads(lines[pos])
                    except json.JSONDecodeError:
                        record = {"p": base64.b64encode(lines[pos].encode()).decode()}
                    metadata = dict(record.get("h") or {})
                    metadata.update({"offset": pos, "group": group})
                    return Message(
                        topic,
                        base64.b64decode(record.get("p", "")),
                        metadata=metadata,
                        committer=lambda p=pos: self._commit(topic, group, p),
                    )
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(0.05)  # poll transport: no file-watch dependency

    def _commit(self, topic: str, group: str, pos: int) -> None:
        """Contiguous-prefix commit (inmemory._commit rule): with concurrent
        workers a fast worker's higher commit must not acknowledge a slower
        worker's uncommitted message."""
        key = (topic, _slug(group))
        with self._lock:
            done = self._done.setdefault(key, set())
            done.add(pos)
            offset = self._read_offset(topic, group)
            while offset in done:
                done.discard(offset)
                offset += 1
            self._write_offset(topic, group, offset)

    def rewind_uncommitted(self, topic: str, group: str = "default") -> None:
        """Redeliver consumed-but-uncommitted messages (what a process
        restart does implicitly; exposed for crash tests, like inmemory)."""
        key = (topic, _slug(group))
        with self._lock:
            self._cursor[key] = self._read_offset(topic, group)

    # -- topic admin -----------------------------------------------------------

    def create_topic(self, topic: str) -> None:
        with open(self._log_path(topic), "a"):
            pass

    def delete_topic(self, topic: str) -> None:
        with self._lock:
            self._log_cache.pop(topic, None)
        try:
            os.remove(self._log_path(topic))
        except FileNotFoundError:
            pass

    def topics(self) -> list[str]:
        return sorted(p[:-4] for p in os.listdir(self.dir) if p.endswith(".log"))

    def health_check(self) -> dict[str, Any]:
        status = "UP" if not self._closed and os.path.isdir(self.dir) else "DOWN"
        return {"status": status,
                "details": {"backend": "file", "dir": os.path.abspath(self.dir),
                            "topics": len(self.topics()) if status == "UP" else 0}}

    def close(self) -> None:
        self._closed = True
