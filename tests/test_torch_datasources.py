"""The port's datasources, migrations and CRUD routes
(``gofr_tpu_torch.datasource``, ``.migration``, ``.crud``) held to
tests/test_datasources.py's cases and the plugin cases of
tests/test_datasource_plugins.py, on the in-repo fakes (``FakeRedis``,
``FakeDBAPIConn``, the in-memory plugin clients), and against the JAX
package on the same calls.

Tolerances: exact. The SQL query builders give equal strings for every
dialect; ``run_migrations`` on the same migrations and fresh sqlite files
leaves equal ``gofr_migrations`` rows (version and method; the start time
and duration are wall-clock readings and are left out) and equal schemas
(``sqlite_master``); the CRUD routes answer the same request sequence with
equal status and body through each App; the health aggregate has equal
keys and statuses for the same wiring.
"""

import dataclasses
import json
import socket
import sys
import threading

import httpx
import pytest

from tests.test_datasources import FakeDBAPIConn, FakeRedis
from tests.test_http_server import AppHarness, _free_port

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.quick


def make_db():
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.datasource.sql import connect_sql
    from gofr_tpu_torch.logging import MockLogger
    from gofr_tpu_torch.metrics import Registry

    reg = Registry()
    reg.new_histogram("app_sql_stats")
    return connect_sql(DictConfig({"DB_DIALECT": "sqlite"}), MockLogger(), reg), reg


def mock_container():
    from gofr_tpu_torch.container import new_mock_container

    return new_mock_container()


# -- tests/test_datasources.py on the port ---------------------------------------------------


def test_sql_query_exec_and_metrics():
    db, reg = make_db()
    db.execute("CREATE TABLE t (id INTEGER PRIMARY KEY, name TEXT)")
    db.execute("INSERT INTO t (id, name) VALUES (?, ?)", (1, "a"))
    rows = db.query("SELECT * FROM t")
    assert rows[0].name == "a"
    assert reg.get("app_sql_stats").count(type="exec") == 2
    assert reg.get("app_sql_stats").count(type="query") == 1
    assert db.health_check()["status"] == "UP"


def test_sql_select_into_dataclass():
    db, _ = make_db()
    db.execute("CREATE TABLE u (id INTEGER, name TEXT, extra TEXT)")
    db.execute("INSERT INTO u VALUES (1, 'x', 'ignored')")

    @dataclasses.dataclass
    class U:
        id: int
        name: str

    assert db.select_into(U, "SELECT * FROM u") == [U(1, "x")]


def test_sql_transaction_rollback():
    db, _ = make_db()
    db.execute("CREATE TABLE t (id INTEGER PRIMARY KEY)")
    with pytest.raises(RuntimeError):
        with db.begin() as tx:
            tx.execute("INSERT INTO t VALUES (1)")
            raise RuntimeError("abort")
    assert db.query("SELECT COUNT(*) AS n FROM t")[0].n == 0
    with db.begin() as tx:
        tx.execute("INSERT INTO t VALUES (2)")
    assert db.query("SELECT COUNT(*) AS n FROM t")[0].n == 1


def test_sql_error_wrapped():
    from gofr_tpu_torch.datasource import DatasourceError

    db, _ = make_db()
    with pytest.raises(DatasourceError):
        db.query("SELECT * FROM missing_table")


def test_query_builder_quoting():
    from gofr_tpu_torch.datasource.sql import insert_query, update_query

    assert insert_query("users", ["id", "name"], "sqlite") == \
        'INSERT INTO "users" ("id", "name") VALUES (?, ?)'
    assert insert_query("users", ["id"], "mysql") == "INSERT INTO `users` (`id`) VALUES (?)"
    assert '"userssemicolon"' not in update_query('users;drop', ["a"], "id", "sqlite")
    assert "drop" in update_query("usersdrop", ["a"], "id", "sqlite")


def test_migrations_apply_once_and_rollback():
    from gofr_tpu_torch.migration import Migration, run_migrations

    c = mock_container()
    c.sql, _ = make_db()
    ran = []
    migrations = {
        1: Migration(up=lambda d: (d.sql.execute("CREATE TABLE m1 (x INTEGER)"), ran.append(1))),
        2: Migration(up=lambda d: ran.append(2)),
    }
    assert run_migrations(migrations, c) == [1, 2]
    assert run_migrations(migrations, c) == []
    assert ran == [1, 2]

    def bad(d):
        d.sql.execute("INSERT INTO m1 VALUES (9)")
        raise RuntimeError("migration fails")

    with pytest.raises(RuntimeError):
        run_migrations({3: Migration(up=bad)}, c)
    assert c.sql.query("SELECT COUNT(*) AS n FROM m1")[0].n == 0
    assert c.sql.query_row("SELECT MAX(version) AS v FROM gofr_migrations")["v"] == 2


def test_failing_migration_leaves_no_partial_redis_state():
    from gofr_tpu_torch.migration import Migration, run_migrations

    c = mock_container()
    c.sql, _ = make_db()
    c.redis = FakeRedis()

    def bad(d):
        d.redis.set("feature_flag", "on")
        d.redis.hset("settings", "mode", "new")
        d.sql.execute("CREATE TABLE mr (x INTEGER)")
        raise RuntimeError("boom after redis writes")

    with pytest.raises(RuntimeError):
        run_migrations({1: Migration(up=bad)}, c)
    assert c.redis.data == {}
    assert c.redis.executed_pipelines == 0
    assert c.sql.query_row("SELECT MAX(version) AS v FROM gofr_migrations")["v"] is None


def test_migration_redis_writes_commit_atomically_with_record():
    from gofr_tpu_torch.migration import Migration, run_migrations

    c = mock_container()
    c.sql, _ = make_db()
    c.redis = FakeRedis()

    def up(d):
        d.redis.set("greeting", "hi")
        d.redis.hset("settings", "mode", "new")
        d.pubsub.create_topic("orders")

    assert run_migrations({1: Migration(up=up)}, c) == [1]
    assert c.redis.data["greeting"] == "hi"
    assert c.redis.data["settings"] == {"mode": "new"}
    assert c.redis.executed_pipelines == 1
    assert "1" in c.redis.data["gofr_migrations"]
    assert "orders" in c.pubsub.topics()
    assert run_migrations({1: Migration(up=up)}, c) == []


def test_redis_only_migrations_run_without_sql():
    from gofr_tpu_torch.migration import Migration, run_migrations

    c = mock_container()
    c.sql = None
    c.redis = FakeRedis()
    ran = []
    assert run_migrations({1: Migration(up=lambda d: (d.redis.incr("n"), ran.append(1)))}, c) == [1]
    assert run_migrations({1: Migration(up=lambda d: ran.append("again"))}, c) == []
    assert ran == [1]
    assert c.redis.data["n"] == 1


@pytest.mark.parametrize("dialect", ["mysql", "postgres"])
def test_dbapi_dialects_normalize_placeholders(dialect):
    from gofr_tpu_torch.datasource import DatasourceError
    from gofr_tpu_torch.datasource.sql import DB, _DBAPIAdapter, insert_query
    from gofr_tpu_torch.logging import MockLogger

    conn = FakeDBAPIConn()
    db = DB(_DBAPIAdapter(conn), dialect, MockLogger(), None, placeholder="%s")
    db.execute("INSERT INTO t (a, b) VALUES (?, ?)", (1, "x"))
    assert conn.executed[-1] == ("INSERT INTO t (a, b) VALUES (%s, %s)", (1, "x"))
    assert conn.commits == 1
    rows = db.query("SELECT n FROM t WHERE a = ?", (1,))
    assert rows[0].n == 1
    assert conn.executed[-1][0] == "SELECT n FROM t WHERE a = %s"
    db.execute_many("INSERT INTO t (a) VALUES (?)", [(1,), (2,)])
    assert conn.executed[-1] == ("INSERT INTO t (a) VALUES (%s)", (2,))
    with pytest.raises(DatasourceError):
        db.execute("boom")
    assert conn.rollbacks == 1
    assert insert_query("t", ["a"], dialect) == ("INSERT INTO `t` (`a`) VALUES (?)"
                                                 if dialect == "mysql"
                                                 else 'INSERT INTO "t" ("a") VALUES (?)')


def test_connect_sql_missing_driver_raises_at_boot(monkeypatch):
    """A dialect whose driver is not installed, or an unknown one, raises
    ``DatasourceError`` at boot, from ``connect_sql`` and from
    ``Container.create``: configured SQL is never left unwired quietly
    (JAX's logs it and returns None: ROADMAP.md Queue C)."""
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.datasource import DatasourceError
    from gofr_tpu_torch.datasource.sql import connect_sql
    from gofr_tpu_torch.logging import MockLogger
    from gofr_tpu_torch.metrics import Registry

    monkeypatch.setitem(sys.modules, "pymysql", None)  # the driver not installed
    reg = Registry()
    reg.new_histogram("app_sql_stats")
    with pytest.raises(DatasourceError, match="pymysql"):
        connect_sql(DictConfig({"DB_DIALECT": "mysql"}), MockLogger(), reg)
    with pytest.raises(DatasourceError, match="unknown DB_DIALECT 'nosuchdb'"):
        connect_sql(DictConfig({"DB_DIALECT": "nosuchdb"}), MockLogger(), reg)
    with pytest.raises(DatasourceError, match="pymysql"):
        Container.create(DictConfig({"DB_DIALECT": "mysql", "LOG_LEVEL": "ERROR"}))


def test_kv_store_roundtrip(tmp_path):
    from gofr_tpu_torch.datasource.kv import KVStore

    kv = KVStore(str(tmp_path / "kv.db"))
    kv.set("a", b"1")
    kv.set("a", "2")
    assert kv.get("a") == b"2"
    assert kv.get("missing") is None
    kv.delete("a")
    assert kv.get("a") is None
    assert kv.health_check()["status"] == "UP"


def test_file_datasource_row_readers(tmp_path):
    from gofr_tpu_torch.datasource.file import LocalFileSystem

    fs = LocalFileSystem(str(tmp_path))
    fs.create("data.json", b'[{"a": 1}, {"a": 2}]')
    assert list(fs.read_rows("data.json")) == [{"a": 1}, {"a": 2}]
    fs.create("data.csv", b"x,y\n1,2\n3,4\n")
    assert list(fs.read_rows("data.csv")) == [{"x": "1", "y": "2"}, {"x": "3", "y": "4"}]
    fs.create("data.jsonl", b'{"b": 1}\n{"b": 2}\n')
    assert list(fs.read_rows("data.jsonl")) == [{"b": 1}, {"b": 2}]
    fs.create("plain.txt", b"l1\nl2\n")
    assert list(fs.read_rows("plain.txt")) == ["l1", "l2"]
    fs.mkdir_all("sub/dir")
    assert fs.exists("sub/dir")
    fs.rename("plain.txt", "renamed.txt")
    assert fs.exists("renamed.txt") and not fs.exists("plain.txt")


def test_inmemory_broker_at_least_once():
    from gofr_tpu_torch.pubsub.inmemory import InMemoryBroker

    b = InMemoryBroker()
    b.publish("t", {"n": 1})
    b.publish("t", {"n": 2})
    m1 = b.subscribe("t", "g", timeout=0.1)
    assert m1.bind(dict) == {"n": 1}
    b.rewind_uncommitted("t", "g")
    m1b = b.subscribe("t", "g", timeout=0.1)
    assert m1b.bind(dict) == {"n": 1}
    m1b.commit()
    assert b.subscribe("t", "g", timeout=0.1).bind(dict) == {"n": 2}
    assert b.subscribe("t", "other", timeout=0.1).bind(dict) == {"n": 1}
    assert b.subscribe("empty", "g", timeout=0.05) is None


def test_container_health_aggregation():
    c = mock_container()
    c.sql, _ = make_db()

    class DownDS:
        def health_check(self):
            return {"status": "DOWN", "details": {}}

    c.redis = DownDS()
    h = c.health()
    assert h["status"] == "DEGRADED"
    assert h["services"]["sql"]["status"] == "UP"
    assert h["services"]["redis"]["status"] == "DOWN"


def test_container_config_gating(tmp_path):
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container

    c = Container.create(DictConfig({}))
    assert c.sql is None and c.redis is None and c.pubsub is None and c.kv is None
    assert c.file is not None  # always wired (container.go:123)
    c2 = Container.create(DictConfig({"DB_DIALECT": "sqlite", "KV_PATH": str(tmp_path / "kv")}))
    assert c2.sql is not None and c2.kv is not None
    assert {"sql", "kv", "file"} <= set(c2.health()["services"])
    c.close()
    c2.close()


def test_inmemory_broker_concurrent_commit_keeps_at_least_once():
    from gofr_tpu_torch.pubsub.inmemory import InMemoryBroker

    b = InMemoryBroker()
    for i in range(3):
        b.publish("t", {"n": i})
    m0, m1, m2 = (b.subscribe("t", group="g", timeout=1) for _ in range(3))
    assert [m.bind()["n"] for m in (m0, m1, m2)] == [0, 1, 2]
    m1.commit()
    m2.commit()
    b.rewind_uncommitted("t", group="g")
    redelivered = b.subscribe("t", group="g", timeout=1)
    assert redelivered is not None and redelivered.bind()["n"] == 0
    redelivered.commit()
    b.rewind_uncommitted("t", group="g")
    assert b.subscribe("t", group="g", timeout=0.1) is None
    b.close()


def test_redis_exec_failure_leaves_durable_pending_marker():
    from gofr_tpu_torch.migration import Migration, run_migrations

    c = mock_container()
    c.sql, _ = make_db()

    class ExplodingPipeRedis(FakeRedis):
        def pipeline(self):
            class _Boom:
                def command(self, *a):
                    return self

                def execute(self):
                    raise ConnectionError("redis died at EXEC")

            return _Boom()

    c.redis = ExplodingPipeRedis()

    def up(d):
        d.sql.execute("CREATE TABLE pend (x INTEGER)")
        d.redis.set("flag", "on")

    with pytest.raises(ConnectionError):
        run_migrations({1: Migration(up=up)}, c)
    row = c.sql.query_row("SELECT method FROM gofr_migrations WHERE version = 1")
    assert row["method"] == "UP:redis-pending"
    with pytest.raises(RuntimeError, match="redis-pending"):
        run_migrations({2: Migration(up=lambda d: None)}, c)
    c.sql.execute("UPDATE gofr_migrations SET method = 'UP' WHERE version = 1")
    c.redis = FakeRedis()
    assert run_migrations({2: Migration(up=lambda d: d.redis.set("k", "v"))}, c) == [2]
    assert c.sql.query_row(
        "SELECT method FROM gofr_migrations WHERE version = 2")["method"] == "UP"


def test_file_provider_seam_wires_hooks_and_health():
    from gofr_tpu_torch.datasource.file import (FileSystemProvider, InMemoryFileSystem,
                                                LocalFileSystem)

    c = mock_container()
    fs = InMemoryFileSystem(bucket="b1")
    assert isinstance(fs, FileSystemProvider)
    assert isinstance(LocalFileSystem("."), FileSystemProvider)
    assert fs.health_check()["status"] == "DOWN"
    c.add_file_store(fs)
    assert c.file is fs
    assert fs.connected and fs.logger is c.logger and fs.metrics is c.metrics
    assert c.health()["services"]["file"]["status"] == "UP"


def test_inmemory_file_provider_full_surface():
    from gofr_tpu_torch.datasource.file import InMemoryFileSystem

    fs = InMemoryFileSystem()
    fs.connect()
    fs.mkdir("data")
    with pytest.raises(FileExistsError):
        fs.mkdir("data")
    fs.mkdir_all("a/b/c")
    assert fs.exists("a/b")
    fs.create("data/rows.jsonl", b'{"a": 1}\n{"a": 2}\n')
    assert list(fs.read_rows("data/rows.jsonl")) == [{"a": 1}, {"a": 2}]
    fs.create("data/notes.txt", b"x\ny\n")
    assert list(fs.read_rows("data/notes.txt")) == ["x", "y"]
    assert fs.list("data") == ["notes.txt", "rows.jsonl"]
    assert fs.open("data/notes.txt").read() == b"x\ny\n"
    assert fs.stat("data/notes.txt").st_size == 4
    fs.rename("data/notes.txt", "data/notes2.txt")
    assert fs.exists("data/notes2.txt") and not fs.exists("data/notes.txt")
    fs.remove("data/notes2.txt")
    with pytest.raises(FileNotFoundError):
        fs.read("data/notes2.txt")
    with pytest.raises(FileNotFoundError):
        fs.create("nodir/x.txt", b"")
    fs.remove_all("data")
    assert not fs.exists("data") and not fs.exists("data/rows.jsonl")
    fs.create(".env", b"A=1\n")
    fs.create("env", b"other\n")
    assert fs.read(".env") == b"A=1\n" and fs.read("env") == b"other\n"
    assert sorted(n for n in fs.list(".") if "env" in n) == [".env", "env"]
    assert fs.read("../.env") == b"A=1\n"


# -- the plugin cases of tests/test_datasource_plugins.py ------------------------------------


def test_mongo_crud_roundtrip():
    from gofr_tpu_torch.datasource.mongo import in_memory_mongo

    c = mock_container()
    m = in_memory_mongo()
    c.add_mongo(m)
    m.insert_one("users", {"name": "ada", "age": 36})
    m.insert_many("users", [{"name": "bob"}, {"name": "eve"}])
    assert m.count_documents("users") == 3
    assert m.find_one("users", {"name": "ada"})["age"] == 36
    m.update_one("users", {"name": "ada"}, {"$set": {"age": 37}})
    assert m.find_one("users", {"name": "ada"})["age"] == 37
    m.update_by_id("users", 2, {"name": "bobby"})
    assert m.find_one("users", {"_id": 2})["name"] == "bobby"
    assert m.delete_one("users", {"name": "eve"}) == 1
    assert m.count_documents("users") == 2
    assert c.mongo is m
    assert c.health()["services"]["mongo"]["status"] == "UP"


def test_mongo_metrics_recorded():
    from gofr_tpu_torch.datasource.mongo import in_memory_mongo

    c = mock_container()
    m = in_memory_mongo()
    c.add_mongo(m)
    m.insert_one("t", {"a": 1})
    assert "app_mongo_stats" in c.metrics.expose_text()


def test_cassandra_exec_query_bind():
    from gofr_tpu_torch.datasource.cassandra import in_memory_cassandra

    c = mock_container()
    cass = in_memory_cassandra()
    c.add_cassandra(cass)
    cass.exec("CREATE TABLE users (id int PRIMARY KEY, name text)")
    cass.exec("INSERT INTO users (id, name) VALUES (?, ?)", 1, "ada")
    cass.exec("INSERT INTO users (id, name) VALUES (?, ?)", 2, "bob")
    assert len(cass.query(dict, "SELECT * FROM users")) == 2

    @dataclasses.dataclass
    class User:
        id: int
        name: str

    assert cass.query_one(User, "SELECT id, name FROM users WHERE id = ?", 1) == User(1, "ada")
    assert c.health()["services"]["cassandra"]["status"] == "UP"


def test_cassandra_exec_cas_lightweight_tx():
    from gofr_tpu_torch.datasource.cassandra import in_memory_cassandra

    cass = in_memory_cassandra()
    cass.connect()
    cass.exec("CREATE TABLE locks (name text PRIMARY KEY)")
    assert cass.exec_cas("INSERT INTO locks (name) VALUES (?) IF NOT EXISTS", "a") is True
    assert cass.exec_cas("INSERT INTO locks (name) VALUES (?) IF NOT EXISTS", "a") is False


def test_clickhouse_exec_select_async_insert():
    from gofr_tpu_torch.datasource.clickhouse import in_memory_clickhouse

    c = mock_container()
    ch = in_memory_clickhouse()
    c.add_clickhouse(ch)
    ch.exec("CREATE TABLE events (id INTEGER, kind TEXT)")
    ch.async_insert("events", [{"id": 1, "kind": "a"}, {"id": 2, "kind": "b"}])
    assert ch.select("SELECT * FROM events ORDER BY id") == [{"id": 1, "kind": "a"},
                                                           {"id": 2, "kind": "b"}]
    assert c.health()["services"]["clickhouse"]["status"] == "UP"


# -- Redis over RESP, against a socket that speaks it ---------------------------------------


class _RESPServer:
    """A RESP2 server on localhost for PING, SET, GET and DEL, enough for
    the client's connect, commands, metrics and health."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self.data: dict[bytes, bytes] = {}
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._client, args=(conn,), daemon=True).start()

    def _client(self, conn):
        f = conn.makefile("rb")
        try:
            while line := f.readline():
                parts = []
                for _ in range(int(line[1:])):
                    n = int(f.readline()[1:])
                    parts.append(f.read(n + 2)[:-2])
                cmd = parts[0].upper()
                if cmd == b"PING":
                    out = b"+PONG\r\n"
                elif cmd == b"SET":
                    self.data[parts[1]] = parts[2]
                    out = b"+OK\r\n"
                elif cmd == b"GET":
                    v = self.data.get(parts[1])
                    out = b"$-1\r\n" if v is None else b"$%d\r\n%s\r\n" % (len(v), v)
                elif cmd == b"DEL":
                    out = b":%d\r\n" % sum(self.data.pop(k, None) is not None for k in parts[1:])
                else:
                    out = b"-ERR unknown command\r\n"
                conn.sendall(out)
        except (OSError, ValueError):
            pass
        finally:
            conn.close()

    def close(self):
        self.sock.close()


def test_redis_client_over_resp_wired_from_config():
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container

    srv = _RESPServer()
    try:
        c = Container.create(DictConfig({"REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(srv.port)}))
        assert c.redis.set("k", "v") and c.redis.get("k") == b"v"
        assert c.redis.delete("k") == 1 and c.redis.get("k") is None
        assert c.metrics.get("app_redis_stats").count(command="SET") == 1
        assert c.health()["services"]["redis"]["status"] == "UP"
        c.close()
    finally:
        srv.close()


def test_unreachable_redis_raises_at_boot():
    """A ``REDIS_HOST`` that does not answer raises ``DatasourceError`` from
    ``Container.create``, naming the address (JAX's logs it and leaves
    ``redis`` None)."""
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.datasource import DatasourceError

    with socket.socket() as s:  # a port bound and released: nothing listens there
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(DatasourceError, match=f"could not connect to redis at 127.0.0.1:{port}"):
        Container.create(DictConfig({"REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(port),
                                     "REDIS_TIMEOUT": "2", "LOG_LEVEL": "ERROR"}))


# -- parity with the JAX package -------------------------------------------------------------


@pytest.mark.parametrize("dialect", ["sqlite", "mysql", "postgres", "other"])
def test_query_builders_equal_the_jax_package(dialect):
    """Every builder on the same table, columns and key, the identifier
    scrubbing included: equal strings."""
    from gofr_tpu.datasource import sql as jsql
    from gofr_tpu_torch.datasource import sql as psql

    for table, cols, key in (("users", ["id", "name"], "id"),
                             ('users;drop "x"', ["a b", "c`d", "e"], "k-ey")):
        for fn, args in (("insert_query", (table, cols)), ("select_all_query", (table,)),
                         ("select_by_query", (table, key)), ("update_query", (table, cols, key)),
                         ("delete_query", (table, key)), ("quote_ident", (table,))):
            assert getattr(psql, fn)(*args, dialect) == getattr(jsql, fn)(*args, dialect), fn


def _migrations(mod):
    """Three migrations and a fourth that fails after writing, the same in
    both packages: a table, an added column, rows, then a rolled-back
    write."""
    def fail(d):
        d.sql.execute("INSERT INTO item (id, name) VALUES (9, 'gone')")
        raise RuntimeError("fails")

    return {
        1: mod.Migration(up=lambda d: d.sql.execute(
            "CREATE TABLE item (id INTEGER PRIMARY KEY, name TEXT)")),
        2: mod.Migration(up=lambda d: d.sql.execute("ALTER TABLE item ADD COLUMN price REAL")),
        3: lambda d: d.sql.execute("INSERT INTO item (id, name, price) VALUES (1, 'a', 2.5)"),
        4: mod.Migration(up=fail),
    }


def test_run_migrations_leaves_the_jax_package_s_records(tmp_path):
    """The same migrations on fresh sqlite files: equal versions applied,
    equal ``gofr_migrations`` versions and methods, equal schemas and rows,
    the failing version rolled back and unrecorded in both."""
    from gofr_tpu import migration as jmig
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.datasource.sql import connect_sql as jax_connect
    from gofr_tpu_torch import migration as pmig
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.datasource.sql import connect_sql

    out = {}
    for name, mod, container, connect, conf in (
            ("jax", jmig, jax_container, jax_connect, JaxConfig),
            ("port", pmig, mock_container, connect_sql, DictConfig)):
        c = container()
        c.sql = connect(conf({"DB_DIALECT": "sqlite", "DB_NAME": str(tmp_path / f"{name}.db")}),
                        c.logger, c.metrics)
        migrations = _migrations(mod)
        applied = mod.run_migrations({v: m for v, m in migrations.items() if v < 4}, c)
        with pytest.raises(RuntimeError, match="fails"):
            mod.run_migrations(migrations, c)
        again = mod.run_migrations({v: m for v, m in migrations.items() if v < 4}, c)
        out[name] = {
            "applied": (applied, again),
            "records": [tuple(r.values()) for r in c.sql.query(
                "SELECT version, method FROM gofr_migrations ORDER BY version")],
            "schema": [tuple(r.values()) for r in c.sql.query(
                "SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY name")],
            "rows": [tuple(r.values()) for r in c.sql.query("SELECT * FROM item ORDER BY id")],
        }
        c.sql.close()
    assert out["port"] == out["jax"]
    assert out["port"]["applied"] == ([1, 2, 3], [])
    assert [r[0] for r in out["port"]["records"]] == [1, 2, 3]


@dataclasses.dataclass
class Book:
    id: int
    title: str
    pages: int


# the same requests in the same order on both Apps: create, list, read,
# update, a missing read, delete, a second delete and a missing update
CRUD_SEQUENCE = (
    ("POST", "/book", {"id": 1, "title": "Dune", "pages": 412}),
    ("POST", "/book", {"id": 2, "title": "Emma", "pages": 474}),
    ("GET", "/book", None),
    ("GET", "/book/1", None),
    ("PUT", "/book/1", {"id": 1, "title": "Dune Messiah", "pages": 256}),
    ("GET", "/book/1", None),
    ("GET", "/book/7", None),
    ("DELETE", "/book/2", None),
    ("DELETE", "/book/2", None),
    ("PUT", "/book/9", {"id": 9, "title": "x", "pages": 1}),
    ("GET", "/book", None),
)


def test_crud_routes_answer_as_the_jax_app(tmp_path):
    """``add_rest_handlers(Book)`` on each App over its own sqlite file:
    every request of ``CRUD_SEQUENCE`` gets equal status and body."""
    from gofr_tpu.app import App as JaxApp
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig

    answers = {}
    for name, app_cls, conf in (("jax", JaxApp, JaxConfig), ("port", App, DictConfig)):
        app = app_cls(config=conf({"HTTP_PORT": str(_free_port()),
                                   "METRICS_PORT": str(_free_port()), "DB_DIALECT": "sqlite",
                                   "DB_NAME": str(tmp_path / f"{name}.db")}))
        app.add_rest_handlers(Book)
        got = []
        with AppHarness(app) as h:
            for method, path, body in CRUD_SEQUENCE:
                r = httpx.request(method, h.base + path, timeout=30,
                                  content=None if body is None else json.dumps(body))
                got.append((r.status_code, r.json() if r.content else None))
        answers[name] = got
    assert answers["port"] == answers["jax"]
    assert [s for s, _ in answers["port"]] == [201, 201, 200, 200, 200, 200, 404, 204, 404,
                                               404, 200]


def test_health_aggregate_equals_the_jax_container(tmp_path):
    """The same wiring (SQL, a KV store, the file store, a Redis that reads
    DOWN and the mongo plugin) on both containers: equal keys, equal
    statuses, equal aggregate."""
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.datasource.file import LocalFileSystem as JaxFS
    from gofr_tpu.datasource.kv import KVStore as JaxKV
    from gofr_tpu.datasource.mongo import in_memory_mongo as jax_mongo
    from gofr_tpu.datasource.sql import connect_sql as jax_connect
    from gofr_tpu_torch.datasource.file import LocalFileSystem
    from gofr_tpu_torch.datasource.kv import KVStore
    from gofr_tpu_torch.datasource.mongo import in_memory_mongo

    class DownDS:
        def health_check(self):
            return {"status": "DOWN", "details": {}}

    got = {}
    for name, c, kv, mongo, fs in (
            ("jax", jax_container(), JaxKV, jax_mongo, JaxFS),
            ("port", mock_container(), KVStore, in_memory_mongo, LocalFileSystem)):
        if name == "jax":
            c.sql = jax_connect(JaxConfig({"DB_DIALECT": "sqlite"}), c.logger, c.metrics)
        else:
            c.sql, _ = make_db()
        c.kv = kv(str(tmp_path / f"{name}.kv"))
        c.file = fs(str(tmp_path))
        c.redis = DownDS()
        c.add_mongo(mongo())
        h = c.health()
        got[name] = (h["status"], {k: v["status"] for k, v in h["services"].items()})
    assert got["port"] == got["jax"]
    assert got["port"][0] == "DEGRADED"
    assert {"sql", "kv", "file", "redis", "mongo", "pubsub", "slo"} == set(got["port"][1])


def test_context_reaches_every_datasource_and_keeps_values():
    """``ctx.sql`` / ``redis`` / ``kv`` / ``file`` / ``mongo`` /
    ``cassandra`` / ``clickhouse`` are the container's (context.py:79-111),
    and ``set_value`` / ``get_value`` keep a request's scratch values."""
    from gofr_tpu_torch.context import Context
    from gofr_tpu_torch.datasource.cassandra import in_memory_cassandra
    from gofr_tpu_torch.datasource.clickhouse import in_memory_clickhouse
    from gofr_tpu_torch.datasource.mongo import in_memory_mongo

    c = mock_container()
    c.sql, _ = make_db()
    c.redis, c.kv, c.file = FakeRedis(), object(), object()
    c.add_mongo(in_memory_mongo())
    c.add_cassandra(in_memory_cassandra())
    c.add_clickhouse(in_memory_clickhouse())
    ctx = Context(None, c)
    for name in ("sql", "redis", "kv", "file", "mongo", "cassandra", "clickhouse"):
        assert getattr(ctx, name) is getattr(c, name) is not None, name
    assert ctx.get_value("k") is None and ctx.get_value("k", 3) == 3
    ctx.set_value("k", [1])
    assert ctx.get_value("k") == [1]
    assert Context(None, c).get_value("k") is None
