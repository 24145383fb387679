"""Config: 12-factor env configuration with dotenv layering (the port's own
copy of gofr_tpu/config/__init__.py).

Mirrors the reference's config semantics (gofr `pkg/gofr/config/godotenv.go:34-68`):
load ``./configs/.env`` first, then overlay ``.{APP_ENV}.env`` (or ``.local.env``
when APP_ENV is unset); every read ultimately consults the process environment so
real env vars always win.
"""

from __future__ import annotations

import os
from typing import Mapping, Protocol


class Config(Protocol):
    """Consumer-facing config interface (gofr `pkg/gofr/config/config.go`)."""

    def get(self, key: str) -> str | None: ...

    def get_or_default(self, key: str, default: str) -> str: ...


def parse_dotenv(text: str) -> dict[str, str]:
    """Parse KEY=VALUE lines; supports comments, blank lines, and quoted values."""
    out: dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("export "):
            line = line[len("export ") :].lstrip()
        if "=" not in line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip()
        if value and value[0] in ("'", '"'):
            quote = value[0]
            closing = value.find(quote, 1)
            if closing != -1:
                # anything after the closing quote (e.g. an inline comment) is dropped
                value = value[1:closing]
        elif " #" in value:
            # strip trailing inline comment on unquoted values
            value = value.split(" #", 1)[0].rstrip()
        if key:
            out[key] = value
    return out


class TypedGetters:
    """Typed convenience getters shared by every config implementation;
    subclasses provide ``get``."""

    def get(self, key: str) -> str | None:  # pragma: no cover - overridden
        raise NotImplementedError

    def get_or_default(self, key: str, default: str) -> str:
        value = self.get(key)
        return value if value not in (None, "") else default

    def get_int(self, key: str, default: int) -> int:
        value = self.get(key)
        if value in (None, ""):
            return default
        try:
            return int(value)  # type: ignore[arg-type]
        except ValueError:
            return default

    def get_float(self, key: str, default: float) -> float:
        value = self.get(key)
        if value in (None, ""):
            return default
        try:
            return float(value)  # type: ignore[arg-type]
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        value = self.get(key)
        if value in (None, ""):
            return default
        return str(value).strip().lower() in ("1", "true", "yes", "on")


class EnvConfig(TypedGetters):
    """Layered env-file config.

    Order of precedence (highest first):
      1. real process environment (``os.environ``)
      2. ``{folder}/.{APP_ENV}.env`` (or ``.local.env`` when APP_ENV unset)
      3. ``{folder}/.env``
    """

    def __init__(self, folder: str = "./configs", environ: Mapping[str, str] | None = None):
        self._environ = environ if environ is not None else os.environ
        self._values: dict[str, str] = {}
        self._load(folder)

    def _load(self, folder: str) -> None:
        base = os.path.join(folder, ".env")
        if os.path.isfile(base):
            with open(base, encoding="utf-8") as f:
                self._values.update(parse_dotenv(f.read()))
        app_env = self._environ.get("APP_ENV", "") or self._values.get("APP_ENV", "")
        overlay_name = f".{app_env}.env" if app_env else ".local.env"
        overlay = os.path.join(folder, overlay_name)
        if os.path.isfile(overlay):
            with open(overlay, encoding="utf-8") as f:
                self._values.update(parse_dotenv(f.read()))

    def get(self, key: str) -> str | None:
        if key in self._environ:
            return self._environ[key]
        return self._values.get(key)


class DictConfig(TypedGetters):
    """In-memory config for tests (analog of gofr's mock config)."""

    def __init__(self, values: Mapping[str, str] | None = None):
        self._values = dict(values or {})

    def get(self, key: str) -> str | None:
        return self._values.get(key)

    def set(self, key: str, value: str) -> None:
        self._values[key] = value
