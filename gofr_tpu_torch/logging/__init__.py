"""Leveled structured logging: JSON when piped, colorized pretty output on a TTY
(the port's own copy of gofr_tpu/logging/__init__.py).

Capability parity with the reference's logging package (gofr `pkg/gofr/logging/`):
six levels DEBUG..FATAL (`level.go:12-19`), TTY-detected pretty-vs-JSON output
(`logger.go:80-84,210-217`), a ``PrettyPrint`` protocol so structured records
(request logs, RPC logs, SQL logs) control their own terminal rendering
(`logger.go:17-19,158-170`) and live level changes.
"""

from __future__ import annotations

import io
import json
import sys
import threading
import time
import traceback
from enum import IntEnum
from typing import Any, Protocol, TextIO, runtime_checkable


class Level(IntEnum):
    DEBUG = 1
    INFO = 2
    NOTICE = 3
    WARN = 4
    ERROR = 5
    FATAL = 6

    @staticmethod
    def parse(name: str, default: "Level | None" = None) -> "Level":
        try:
            return Level[name.strip().upper()]
        except KeyError:
            return default if default is not None else Level.INFO


_LEVEL_COLORS = {
    Level.DEBUG: 36,  # cyan
    Level.INFO: 34,  # blue
    Level.NOTICE: 35,  # magenta
    Level.WARN: 33,  # yellow
    Level.ERROR: 31,  # red
    Level.FATAL: 31,
}


@runtime_checkable
class PrettyPrint(Protocol):
    """Structured records implement this to control their TTY rendering."""

    def pretty_print(self, writer: TextIO) -> None: ...


class Logger:
    """Thread-safe leveled logger.

    ``terminal=None`` auto-detects: pretty colorized output on a TTY, one JSON
    object per line otherwise.
    """

    def __init__(
        self,
        level: Level = Level.INFO,
        out: TextIO | None = None,
        err: TextIO | None = None,
        terminal: bool | None = None,
    ):
        self._level = level
        self._out = out if out is not None else sys.stdout
        self._err = err if err is not None else sys.stderr
        if terminal is None:
            terminal = bool(getattr(self._out, "isatty", lambda: False)())
        self._terminal = terminal
        self._lock = threading.Lock()

    # -- level management (live change supports the remote-level poller) ------

    @property
    def level(self) -> Level:
        return self._level

    def change_level(self, level: Level) -> None:
        self._level = level

    # -- log methods -----------------------------------------------------------

    def debug(self, *args: Any) -> None:
        self._log(Level.DEBUG, args)

    def debugf(self, fmt: str, *args: Any) -> None:
        self._logf(Level.DEBUG, fmt, args)

    def info(self, *args: Any) -> None:
        self._log(Level.INFO, args)

    def infof(self, fmt: str, *args: Any) -> None:
        self._logf(Level.INFO, fmt, args)

    def notice(self, *args: Any) -> None:
        self._log(Level.NOTICE, args)

    def noticef(self, fmt: str, *args: Any) -> None:
        self._logf(Level.NOTICE, fmt, args)

    def warn(self, *args: Any) -> None:
        self._log(Level.WARN, args)

    def warnf(self, fmt: str, *args: Any) -> None:
        self._logf(Level.WARN, fmt, args)

    def error(self, *args: Any) -> None:
        self._log(Level.ERROR, args)

    def errorf(self, fmt: str, *args: Any) -> None:
        self._logf(Level.ERROR, fmt, args)

    def fatal(self, *args: Any) -> None:
        self._log(Level.FATAL, args)

    def fatalf(self, fmt: str, *args: Any) -> None:
        self._logf(Level.FATAL, fmt, args)

    def log_exception(self, exc: BaseException, note: str = "") -> None:
        stack = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        self.error(f"{note + ': ' if note else ''}{exc!r}\n{stack}")

    # -- internals -------------------------------------------------------------

    def _logf(self, level: Level, fmt: str, args: tuple[Any, ...]) -> None:
        if level < self._level:
            return
        try:
            message = fmt % args if args else fmt
        except (TypeError, ValueError):
            message = " ".join([fmt, *map(str, args)])
        self._log(level, (message,))

    def _log(self, level: Level, args: tuple[Any, ...]) -> None:
        if level < self._level:
            return
        stream = self._err if level >= Level.ERROR else self._out
        now = time.time()
        if self._terminal:
            self._write_pretty(stream, level, now, args)
        else:
            self._write_json(stream, level, now, args)

    def _write_json(self, stream: TextIO, level: Level, now: float, args: tuple[Any, ...]) -> None:
        structured: dict[str, Any] = {}
        plain: list[str] = []
        for arg in args:
            if isinstance(arg, dict):
                structured.update(arg)
            elif hasattr(arg, "to_log_dict"):
                structured.update(arg.to_log_dict())
            elif isinstance(arg, PrettyPrint):
                structured.update(_object_fields(arg))
            else:
                plain.append(str(arg))
        # metadata keys always win over structured fields of the same name so a
        # payload containing "level"/"time"/"message" can't corrupt the record
        message = " ".join(plain) if plain else structured.get("message", "")
        for reserved in ("level", "time", "message"):
            structured.pop(reserved, None)
        record = {
            "level": level.name,
            "time": _rfc3339(now),
            "message": message,
            **structured,
        }
        line = json.dumps(record, default=str)
        with self._lock:
            stream.write(line + "\n")
            stream.flush()

    def _write_pretty(self, stream: TextIO, level: Level, now: float, args: tuple[Any, ...]) -> None:
        color = _LEVEL_COLORS[level]
        prefix = f"\x1b[{color}m{level.name:<6}\x1b[0m [{time.strftime('%H:%M:%S', time.localtime(now))}] "
        buf = io.StringIO()
        buf.write(prefix)
        for arg in args:
            if isinstance(arg, PrettyPrint):
                buf.write("\n")
                arg.pretty_print(buf)
            else:
                buf.write(str(arg))
                buf.write(" ")
        with self._lock:
            stream.write(buf.getvalue().rstrip(" ") + "\n")
            stream.flush()


def _object_fields(obj: Any) -> dict[str, Any]:
    if hasattr(obj, "__dict__"):
        return {k: v for k, v in vars(obj).items() if not k.startswith("_")}
    return {"value": str(obj)}


def _rfc3339(ts: float) -> str:
    ms = int((ts % 1) * 1000)
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts)) + f".{ms:03d}Z"


def new_logger(level_name: str = "INFO", **kw: Any) -> Logger:
    return Logger(level=Level.parse(level_name), **kw)


class MockLogger(Logger):
    """Captures log lines for assertions in tests."""

    def __init__(self, level: Level = Level.DEBUG):
        self.buffer = io.StringIO()
        super().__init__(level=level, out=self.buffer, err=self.buffer, terminal=False)

    @property
    def lines(self) -> list[str]:
        return [line for line in self.buffer.getvalue().splitlines() if line]

    @property
    def records(self) -> list[dict[str, Any]]:
        out = []
        for line in self.lines:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                out.append({"message": line})
        return out
