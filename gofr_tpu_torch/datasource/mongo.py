"""Mongo datasource plugin (gofr `pkg/gofr/datasource/mongo/`, separate-
module tier — SURVEY.md §2.4).

Injected by the user via ``app.add_mongo(Mongo(...))``; the container runs
the ``use_logger/use_metrics/connect`` provider lifecycle
(`external_db.go:8-52` pattern). The underlying client class is injectable
(`client_factory``) so the driver is testable without a server — the same
interface-indirection move the reference makes for cassandra
(`cassandra.go:22-26`); ``InMemoryMongo`` is an in-tree fake implementing
the collection surface.

Every operation logs at debug with µs duration and records the
``app_mongo_stats`` histogram (reference: per-driver `app_*_stats`).

The port's own copy of gofr_tpu/datasource/mongo.py.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from gofr_tpu_torch.datasource import DatasourceError


class Mongo:
    """Narrow consumer interface (container/datasources.go:119-171 parity):
    insert_one/insert_many/find/find_one/update_by_id/update_one/update_many/
    count_documents/delete_one/delete_many/drop + health_check."""

    def __init__(
        self,
        uri: str | None = None,
        database: str = "test",
        client_factory: Callable[..., Any] | None = None,
    ):
        self._uri = uri
        self._db_name = database
        self._client_factory = client_factory
        self._client = None
        self._db = None
        self.logger = None
        self.metrics = None

    # -- provider lifecycle ----------------------------------------------------

    def use_logger(self, logger) -> None:
        self.logger = logger

    def use_metrics(self, metrics) -> None:
        self.metrics = metrics
        try:
            metrics.new_histogram(
                "app_mongo_stats", "mongo operation duration (µs)",
                buckets=[50, 200, 1000, 5000, 20000, 100000, 500000],
            )
        except Exception:  # noqa: BLE001 - already registered
            pass

    def connect(self) -> None:
        factory = self._client_factory
        if factory is None:
            try:
                from pymongo import MongoClient as factory  # type: ignore[import-not-found]
            except ImportError as e:
                raise DatasourceError(e, "pymongo not installed; pass client_factory") from e
        self._client = factory(self._uri) if self._uri else factory()
        self._db = self._client[self._db_name]
        if self.logger:
            self.logger.info(f"connected to mongo database {self._db_name!r}")

    # -- operations ------------------------------------------------------------

    def _observe(self, op: str, collection: str, start: float) -> None:
        micros = (time.perf_counter() - start) * 1e6
        if self.metrics:
            self.metrics.record_histogram("app_mongo_stats", micros, operation=op)
        if self.logger:
            self.logger.debug({"type": "mongo", "operation": op,
                               "collection": collection, "duration_us": round(micros, 1)})

    def _run(self, op: str, collection: str, fn: Callable[[Any], Any]) -> Any:
        if self._db is None:
            raise DatasourceError("mongo not connected", "call connect() first")
        start = time.perf_counter()
        try:
            return fn(self._db[collection])
        except DatasourceError:
            raise
        except Exception as e:  # noqa: BLE001
            raise DatasourceError(e, f"mongo {op} on {collection!r} failed") from e
        finally:
            self._observe(op, collection, start)

    def insert_one(self, collection: str, document: dict) -> Any:
        return self._run("insertOne", collection, lambda c: c.insert_one(document))

    def insert_many(self, collection: str, documents: list[dict]) -> Any:
        return self._run("insertMany", collection, lambda c: c.insert_many(documents))

    def find(self, collection: str, filter: dict | None = None, **kw) -> list[dict]:
        return self._run("find", collection, lambda c: list(c.find(filter or {}, **kw)))

    def find_one(self, collection: str, filter: dict | None = None, **kw) -> dict | None:
        return self._run("findOne", collection, lambda c: c.find_one(filter or {}, **kw))

    def update_one(self, collection: str, filter: dict, update: dict) -> Any:
        return self._run("updateOne", collection, lambda c: c.update_one(filter, update))

    def update_many(self, collection: str, filter: dict, update: dict) -> Any:
        return self._run("updateMany", collection, lambda c: c.update_many(filter, update))

    def update_by_id(self, collection: str, id: Any, update: dict) -> Any:
        return self._run("updateByID", collection,
                         lambda c: c.update_one({"_id": id}, {"$set": update}))

    def count_documents(self, collection: str, filter: dict | None = None) -> int:
        return self._run("countDocuments", collection, lambda c: c.count_documents(filter or {}))

    def delete_one(self, collection: str, filter: dict) -> int:
        return self._run("deleteOne", collection, lambda c: c.delete_one(filter).deleted_count)

    def delete_many(self, collection: str, filter: dict) -> int:
        return self._run("deleteMany", collection, lambda c: c.delete_many(filter).deleted_count)

    def drop(self, collection: str) -> None:
        self._run("drop", collection, lambda c: c.drop())

    def health_check(self) -> dict[str, Any]:
        if self._client is None:
            return {"status": "DOWN", "details": {"error": "not connected"}}
        try:
            ping = getattr(self._client, "admin", None)
            if ping is not None and hasattr(ping, "command"):
                ping.command("ping")
            return {"status": "UP", "details": {"database": self._db_name}}
        except Exception as e:  # noqa: BLE001
            return {"status": "DOWN", "details": {"error": str(e)}}


# -- in-tree fake (hermetic tests / dev; MockContainer tier of SURVEY.md §4) ---


class _Result:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class _InMemoryCollection:
    def __init__(self):
        self._docs: list[dict] = []
        self._next_id = 0

    def insert_one(self, doc: dict):
        doc = dict(doc)
        if "_id" not in doc:
            self._next_id += 1
            doc["_id"] = self._next_id
        self._docs.append(doc)
        return _Result(inserted_id=doc["_id"])

    def insert_many(self, docs: list[dict]):
        return _Result(inserted_ids=[self.insert_one(d).inserted_id for d in docs])

    def _match(self, doc: dict, filt: dict) -> bool:
        return all(doc.get(k) == v for k, v in filt.items())

    def find(self, filt: dict | None = None, **_kw):
        return [dict(d) for d in self._docs if self._match(d, filt or {})]

    def find_one(self, filt: dict | None = None, **_kw):
        hits = self.find(filt)
        return hits[0] if hits else None

    def _apply(self, doc: dict, update: dict) -> None:
        for k, v in update.get("$set", {}).items():
            doc[k] = v
        for k, v in update.get("$inc", {}).items():
            doc[k] = doc.get(k, 0) + v

    def update_one(self, filt: dict, update: dict):
        for d in self._docs:
            if self._match(d, filt):
                self._apply(d, update)
                return _Result(matched_count=1, modified_count=1)
        return _Result(matched_count=0, modified_count=0)

    def update_many(self, filt: dict, update: dict):
        n = 0
        for d in self._docs:
            if self._match(d, filt):
                self._apply(d, update)
                n += 1
        return _Result(matched_count=n, modified_count=n)

    def count_documents(self, filt: dict | None = None) -> int:
        return len(self.find(filt))

    def delete_one(self, filt: dict):
        for i, d in enumerate(self._docs):
            if self._match(d, filt):
                del self._docs[i]
                return _Result(deleted_count=1)
        return _Result(deleted_count=0)

    def delete_many(self, filt: dict):
        before = len(self._docs)
        self._docs = [d for d in self._docs if not self._match(d, filt)]
        return _Result(deleted_count=before - len(self._docs))

    def drop(self):
        self._docs = []


class _InMemoryDatabase:
    def __init__(self):
        self._collections: dict[str, _InMemoryCollection] = {}

    def __getitem__(self, name: str) -> _InMemoryCollection:
        return self._collections.setdefault(name, _InMemoryCollection())


class InMemoryMongoClient:
    """Drop-in ``client_factory`` for hermetic tests: a dict-backed store
    with the collection surface the driver touches."""

    def __init__(self, *_a, **_kw):
        self._dbs: dict[str, _InMemoryDatabase] = {}

    def __getitem__(self, name: str) -> _InMemoryDatabase:
        return self._dbs.setdefault(name, _InMemoryDatabase())


def in_memory_mongo(database: str = "test") -> Mongo:
    """A connected Mongo driver over the in-memory fake."""
    return Mongo(database=database, client_factory=InMemoryMongoClient)
