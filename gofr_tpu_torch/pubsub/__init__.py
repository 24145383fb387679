"""Pub/Sub: publisher/subscriber interfaces + backend switch.

Parity with gofr `pkg/gofr/datasource/pubsub/`: ``Publisher``/``Subscriber``
interfaces (`interface.go:11-26`), a ``Message`` that implements the
transport-neutral Request interface so subscribe handlers look identical to
HTTP handlers (`message.go:13-103`), at-least-once commit semantics, and the
container's backend-by-config switch (`container/container.go:95-122`).

Backends: ``inmemory`` (in-tree, also the test double) and ``file`` (in-tree,
cross-PROCESS coordination over a shared directory — pubsub/file.py).

The port's own copy of gofr_tpu/pubsub/__init__.py. ``kafka``, ``google`` /
``gcp`` and ``mqtt`` are not ported (ROADMAP.md Queue A 10): they need
client libraries the card's installation lacks, so ``connect_pubsub``
refuses them with an error rather than serving without a broker. An unknown
backend logs and wires nothing, as in JAX.
"""

from __future__ import annotations

import json
from typing import Any, Protocol

from gofr_tpu_torch.utils import bind as binder


class Message:
    """A received message; implements the Request interface for handlers."""

    def __init__(self, topic: str, value: bytes, metadata: dict[str, Any] | None = None, committer=None):
        self.topic = topic
        self.value = value
        self.metadata = metadata or {}
        self._committer = committer
        self.committed = False
        self._ctx: dict[str, Any] = {}

    # -- Request interface -----------------------------------------------------

    def param(self, key: str) -> str:
        v = self.metadata.get(key)
        return str(v) if v is not None else ""

    def params(self, key: str) -> list[str]:
        v = self.param(key)
        return [v] if v else []

    def path_param(self, key: str) -> str:
        return self.topic if key in ("topic", "") else self.param(key)

    def bind(self, target: Any = dict) -> Any:
        if target is bytes:
            return self.value
        if target is str:
            return self.value.decode()
        text = self.value.decode()
        if target in (int, float, bool):
            return binder.bind_value(text, target)
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise binder.BindError(f"message on {self.topic!r} is not JSON") from e
        return binder.bind(data, target)

    def host_name(self) -> str:
        return self.topic

    def context(self) -> dict[str, Any]:
        return self._ctx

    # -- commit (at-least-once) ------------------------------------------------

    def commit(self) -> None:
        if self._committer is not None and not self.committed:
            self._committer()
        self.committed = True


class PubSub(Protocol):
    def publish(self, topic: str, payload: Any, headers: dict | None = None) -> None:
        """Publish; ``headers`` (optional, in-tree brokers support it) carry
        cross-cutting metadata like the W3C traceparent and surface on the
        consumer side through ``Message.param``."""
        ...

    def subscribe(self, topic: str, group: str = "", timeout: float | None = None) -> Message | None:
        """Block until the next message for ``topic`` (None on shutdown).
        ``timeout`` (supported by every in-tree broker; the app's
        subscriber loop and the router's gossip loop poll with it) bounds
        the wait and returns None on expiry."""
        ...

    def health_check(self) -> dict[str, Any]: ...

    def close(self) -> None: ...


def encode_payload(payload: Any) -> bytes:
    if isinstance(payload, bytes):
        return payload
    if isinstance(payload, str):
        return payload.encode()
    return json.dumps(payload, default=str).encode()


NOT_PORTED = ("kafka", "google", "gcp", "mqtt")


def connect_pubsub(backend: str, config, logger, metrics):
    if backend in ("inmemory", "memory", "mock"):
        from gofr_tpu_torch.pubsub.inmemory import InMemoryBroker

        logger.info("using in-memory pubsub broker")
        return InMemoryBroker()
    if backend == "file":
        from gofr_tpu_torch.pubsub.file import FileBroker

        directory = config.get_or_default("PUBSUB_DIR", "./pubsub-data")
        logger.infof("using file pubsub broker under %s", directory)
        return FileBroker(directory)
    if backend in NOT_PORTED:
        raise ValueError(f"PUBSUB_BACKEND={backend} is not ported to gofr_tpu_torch yet "
                         "(ROADMAP.md Queue A 10): use 'inmemory' or 'file'")
    logger.warnf("unknown PUBSUB_BACKEND %r; pubsub not wired", backend)
    return None
