"""JSON-envelope responder (gofr `pkg/gofr/http/responder.go`; the port's own
copy of gofr_tpu/http/responder.py).

Turns a handler's ``(result, error)`` into wire form: ``{"data": ...}`` on
success, ``{"error": {"message": ...}}`` on failure; status derived from the
method and the error's ``status_code`` (POST→201, DELETE→204, typed errors keep
their code). ``Raw``/``File``/``Redirect``/``Response`` bypass or extend the
envelope.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from gofr_tpu_torch.http.errors import retry_after_hint, status_of
from gofr_tpu_torch.http.responses import File, Raw, Redirect, Response


def _default(o: Any) -> Any:
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return dataclasses.asdict(o)
    if hasattr(o, "to_dict"):
        return o.to_dict()
    if hasattr(o, "tolist"):  # numpy arrays, tensors
        return o.tolist()
    if hasattr(o, "item") and getattr(o, "shape", None) == ():
        return o.item()
    if isinstance(o, bytes):
        return o.decode(errors="replace")
    if isinstance(o, (set, frozenset)):
        return sorted(o)
    return str(o)


def to_json(data: Any) -> bytes:
    return json.dumps(data, default=_default).encode()


@dataclasses.dataclass
class WireResponse:
    status: int
    body: bytes
    content_type: str = "application/json"
    headers: dict[str, str] = dataclasses.field(default_factory=dict)


def respond(result: Any, err: BaseException | None, method: str = "GET") -> WireResponse:
    if err is not None:
        status = status_of(err, method)
        message = getattr(err, "message", None) or str(err) or "internal server error"
        if status >= 500 and not getattr(err, "status_code", None):
            # don't leak internals for unexpected exceptions
            message = "some unexpected error has occurred"
        headers = {}
        retry_after = getattr(err, "retry_after", None)
        if retry_after is not None and status in (429, 503):
            # QoS rejections (429 rate / 503 shed) tell clients WHEN to come
            # back instead of inviting an immediate retry storm
            headers["Retry-After"] = retry_after_hint(retry_after)
        return WireResponse(status, to_json({"error": {"message": message}}), headers=headers)

    if isinstance(result, Redirect):
        return WireResponse(result.status_code, b"", headers={"Location": result.url})
    if isinstance(result, File):
        return WireResponse(200, result.content, content_type=result.content_type)
    if isinstance(result, Raw):
        return WireResponse(status_of(None, method), to_json(result.data))
    if isinstance(result, Response):
        status = result.status_code if result.status_code is not None else status_of(None, method)
        return WireResponse(status, to_json({"data": result.data}), headers=dict(result.headers))

    status = status_of(None, method)
    if status == 204:
        return WireResponse(204, b"")
    return WireResponse(status, to_json({"data": result}))
