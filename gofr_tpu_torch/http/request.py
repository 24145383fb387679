"""HTTP request wrapper: the HTTP implementation of the transport-neutral
Request interface (gofr `pkg/gofr/http/request.go`; the port's own copy of
gofr_tpu/http/request.py, less multipart binding, which waits with file
uploads).

The server materializes the body BEFORE the handler runs, so the request is
fully synchronous and safe to hand to sync handlers running in worker threads —
the transport-neutral analog of the reference buffering/re-buffering the body
(`request.go:86-95`).
"""

from __future__ import annotations

import json
from typing import Any, Mapping
from urllib.parse import parse_qs

from gofr_tpu_torch.http.errors import InvalidParam
from gofr_tpu_torch.utils import bind as binder


class HTTPRequest:
    """The HTTP request a handler's context reads (the transport-neutral
    interface of gofr `pkg/gofr/gofr.go` Request)."""

    def __init__(
        self,
        method: str,
        path: str,
        query_string: str = "",
        headers: Mapping[str, str] | None = None,
        body: bytes = b"",
        path_params: Mapping[str, str] | None = None,
        route_template: str = "",
    ):
        self.method = method
        self.path = path
        self.headers = _CIDict(headers or {})
        self.body = body
        self.route_template = route_template or path
        self.query_string = query_string
        self._query = parse_qs(query_string, keep_blank_values=True)
        self._path_params = dict(path_params or {})
        self._ctx: dict[str, Any] = {}


    def param(self, key: str) -> str:
        values = self._query.get(key)
        return values[0] if values else ""

    def params(self, key: str) -> list[str]:
        # comma-split multi-values like the reference's query params
        out: list[str] = []
        for v in self._query.get(key, []):
            out.extend(p for p in v.split(",") if p != "")
        return out

    def path_param(self, key: str) -> str:
        return self._path_params.get(key, "")

    def bind(self, target: Any = dict) -> Any:
        content_type = (self.headers.get("Content-Type") or "").split(";")[0].strip().lower()
        if content_type in ("", "application/json"):
            if not self.body:
                data: Any = {}
            else:
                try:
                    data = json.loads(self.body)
                except json.JSONDecodeError as e:
                    raise InvalidParam("body") from e
            return binder.bind(data, target)
        if content_type == "application/x-www-form-urlencoded":
            form = {k: v[0] if len(v) == 1 else v for k, v in parse_qs(self.body.decode(), keep_blank_values=True).items()}
            return binder.bind(form, target)
        if content_type.startswith("text/"):
            if target in (str, bytes):
                return self.body.decode() if target is str else self.body
            return binder.bind(self.body.decode(), target)
        raise InvalidParam("Content-Type")

    def context(self) -> dict[str, Any]:
        return self._ctx


class _CIDict(dict):
    """Case-insensitive header map."""

    def __init__(self, data: Mapping[str, str]):
        super().__init__()
        for k, v in data.items():
            self[k] = v

    def __setitem__(self, key: str, value: str) -> None:
        super().__setitem__(key.lower(), value)

    def __getitem__(self, key: str) -> str:
        return super().__getitem__(key.lower())

    def get(self, key: str, default: str | None = None) -> str | None:  # type: ignore[override]
        return super().get(key.lower(), default)

    def __contains__(self, key: object) -> bool:
        return super().__contains__(str(key).lower())
