"""File datasource: local filesystem with typed row readers, plus the
remote-filesystem provider seam.

Parity with gofr `pkg/gofr/datasource/file/`: Create/Mkdir/Open/Remove/Rename
surface plus ``read_rows`` returning JSON/CSV/text row iterators selected by
extension (`file/file.go:50-56`). Remote filesystems plug in by implementing
the same methods — the ``FileSystemProvider`` pattern (`file/file.go:69-78`):
``app.add_file_store(provider)`` swaps ``container.file`` for the provider,
wiring its optional ``use_logger``/``use_metrics``/``connect`` hooks exactly
like the external-DB plugins, and handlers keep using ``ctx.file`` unchanged.
``InMemoryFileSystem`` is the in-tree provider fake (the MockPubSub
discipline): a functional remote-FS stand-in tests drive the seam with.

The port's own copy of gofr_tpu/datasource/file.py.
"""

from __future__ import annotations

import csv
import io
import json
import os
import posixpath
import shutil
import time
from typing import Any, Iterator, Protocol, runtime_checkable


@runtime_checkable
class FileSystemProvider(Protocol):
    """The surface ``app.add_file_store`` expects (file.go:69-78 parity).

    Optional plugin hooks — ``use_logger(logger)``, ``use_metrics(metrics)``,
    ``connect()`` — are called at registration when present, in that order
    (the `external_db.go` wiring contract)."""

    def create(self, name: str, data: bytes = b"") -> None: ...

    def read(self, name: str) -> bytes: ...

    def open(self, name: str, mode: str = "rb") -> Any: ...

    def mkdir(self, name: str) -> None: ...

    def mkdir_all(self, name: str) -> None: ...

    def remove(self, name: str) -> None: ...

    def remove_all(self, name: str) -> None: ...

    def rename(self, old: str, new: str) -> None: ...

    def exists(self, name: str) -> bool: ...

    def list(self, name: str = ".") -> list[str]: ...

    def stat(self, name: str) -> Any: ...

    def read_rows(self, name: str) -> Iterator[Any]: ...

    def health_check(self) -> dict[str, Any]: ...


def parse_rows(name: str, data: bytes) -> Iterator[Any]:
    """Extension-dispatched row parsing shared by every provider: dicts for
    .json/.jsonl, dicts for .csv (header row), stripped lines otherwise."""
    ext = os.path.splitext(name)[1].lower()
    if ext == ".json":
        parsed = json.loads(data)
        yield from (parsed if isinstance(parsed, list) else [parsed])
    elif ext == ".jsonl":
        for line in data.splitlines():
            if line.strip():
                yield json.loads(line)
    elif ext == ".csv":
        reader = csv.DictReader(io.StringIO(data.decode()))
        yield from reader
    else:
        for line in data.decode(errors="replace").splitlines():
            yield line


class LocalFileSystem:
    def __init__(self, root: str = "."):
        self.root = root

    def _p(self, name: str) -> str:
        return name if os.path.isabs(name) else os.path.join(self.root, name)

    def create(self, name: str, data: bytes = b"") -> None:
        with open(self._p(name), "wb") as f:
            f.write(data)

    def read(self, name: str) -> bytes:
        with open(self._p(name), "rb") as f:
            return f.read()

    def open(self, name: str, mode: str = "rb"):
        return open(self._p(name), mode)

    def mkdir(self, name: str) -> None:
        os.mkdir(self._p(name))

    def mkdir_all(self, name: str) -> None:
        os.makedirs(self._p(name), exist_ok=True)

    def remove(self, name: str) -> None:
        os.remove(self._p(name))

    def remove_all(self, name: str) -> None:
        shutil.rmtree(self._p(name), ignore_errors=True)

    def rename(self, old: str, new: str) -> None:
        os.replace(self._p(old), self._p(new))

    def exists(self, name: str) -> bool:
        return os.path.exists(self._p(name))

    def list(self, name: str = ".") -> list[str]:
        return sorted(os.listdir(self._p(name)))

    def stat(self, name: str) -> os.stat_result:
        return os.stat(self._p(name))

    # -- row readers (extension-dispatched) ------------------------------------

    def read_rows(self, name: str) -> Iterator[Any]:
        """Yield rows: dicts for .json/.jsonl, dicts for .csv (header row),
        stripped lines for anything else."""
        yield from parse_rows(name, self.read(name))

    def health_check(self) -> dict[str, Any]:
        usage = shutil.disk_usage(self.root)
        return {"status": "UP", "details": {"root": os.path.abspath(self.root), "free_bytes": usage.free}}


class _MemStat:
    """stat()-shaped result for the in-memory provider."""

    __slots__ = ("st_size", "st_mtime", "st_mode")

    def __init__(self, size: int, mtime: float, is_dir: bool):
        self.st_size = size
        self.st_mtime = mtime
        self.st_mode = 0o040755 if is_dir else 0o100644


class InMemoryFileSystem:
    """Remote-FS provider fake: the full ``FileSystemProvider`` surface over
    an in-process dict keyed by normalized POSIX paths, including the plugin
    hooks (``use_logger``/``use_metrics``/``connect``) so the registration
    wiring itself is testable. DOWN until ``connect()`` runs — like a remote
    client before its session is established."""

    def __init__(self, bucket: str = "mem"):
        self.bucket = bucket
        self.files: dict[str, bytes] = {}
        self.dirs: set[str] = {""}
        self.logger = None
        self.metrics = None
        self.connected = False

    # -- plugin hooks (external_db.go wiring contract) -------------------------

    def use_logger(self, logger) -> None:
        self.logger = logger

    def use_metrics(self, metrics) -> None:
        self.metrics = metrics

    def connect(self) -> None:
        self.connected = True
        if self.logger is not None:
            self.logger.infof("connected to in-memory file store %s", self.bucket)

    # -- provider surface ------------------------------------------------------

    @staticmethod
    def _norm(name: str) -> str:
        if name in (".", "", "/"):
            return ""
        path = posixpath.normpath(str(name).replace("\\", "/")).lstrip("/")
        # normpath collapsed interior ".."; clip any still escaping the
        # root. Dotfile names (".env") must survive intact — strip path
        # STRUCTURE only, never characters of a component.
        while path == ".." or path.startswith("../"):
            path = path[2:].lstrip("/")
        return "" if path == "." else path

    def _parent_ok(self, path: str) -> None:
        parent = posixpath.dirname(path)
        if parent and parent not in self.dirs:
            raise FileNotFoundError(f"no such directory: {parent!r}")

    def create(self, name: str, data: bytes = b"") -> None:
        path = self._norm(name)
        self._parent_ok(path)
        self.files[path] = bytes(data)

    def read(self, name: str) -> bytes:
        path = self._norm(name)
        if path not in self.files:
            raise FileNotFoundError(name)
        return self.files[path]

    def open(self, name: str, mode: str = "rb"):
        if "w" in mode or "a" in mode:
            raise NotImplementedError("in-memory provider opens read-only")
        data = self.read(name)
        return io.StringIO(data.decode()) if "b" not in mode else io.BytesIO(data)

    def mkdir(self, name: str) -> None:
        path = self._norm(name)
        if path in self.dirs:
            raise FileExistsError(name)
        self._parent_ok(path)
        self.dirs.add(path)

    def mkdir_all(self, name: str) -> None:
        path = self._norm(name)
        while path:
            self.dirs.add(path)
            path = posixpath.dirname(path)

    def remove(self, name: str) -> None:
        path = self._norm(name)
        if path not in self.files:
            raise FileNotFoundError(name)
        del self.files[path]

    def remove_all(self, name: str) -> None:
        path = self._norm(name)
        self.files = {p: v for p, v in self.files.items()
                      if p != path and not p.startswith(path + "/")}
        self.dirs = {d for d in self.dirs
                     if d != path and not d.startswith(path + "/")}

    def rename(self, old: str, new: str) -> None:
        src, dst = self._norm(old), self._norm(new)
        if src not in self.files:
            raise FileNotFoundError(old)
        self._parent_ok(dst)
        self.files[dst] = self.files.pop(src)

    def exists(self, name: str) -> bool:
        path = self._norm(name)
        return path in self.files or path in self.dirs

    def list(self, name: str = ".") -> list[str]:
        path = self._norm(name)
        if path and path not in self.dirs:
            raise FileNotFoundError(name)
        prefix = path + "/" if path else ""
        out = set()
        for p in list(self.files) + list(self.dirs - {""}):
            if p.startswith(prefix) and p != path:
                out.add(p[len(prefix):].split("/", 1)[0])
        return sorted(out)

    def stat(self, name: str) -> _MemStat:
        path = self._norm(name)
        if path in self.files:
            return _MemStat(len(self.files[path]), time.time(), False)
        if path in self.dirs:
            return _MemStat(0, time.time(), True)
        raise FileNotFoundError(name)

    def read_rows(self, name: str) -> Iterator[Any]:
        yield from parse_rows(name, self.read(name))

    def health_check(self) -> dict[str, Any]:
        if not self.connected:
            return {"status": "DOWN", "details": {"error": "not connected"}}
        return {"status": "UP",
                "details": {"backend": "inmemory-fs", "bucket": self.bucket,
                            "files": len(self.files)}}
