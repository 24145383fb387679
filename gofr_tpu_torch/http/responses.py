"""Response types that bypass or extend the JSON envelope (the port's own
copy of gofr_tpu/http/responses.py).

Parity with gofr `pkg/gofr/http/response/{raw,file}.go`: handlers usually return
plain Python values that get enveloped as ``{"data": ...}``; returning one of
these types instead controls the wire bytes directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Raw:
    """Serialize ``data`` as JSON but WITHOUT the ``{"data": ...}`` envelope."""

    data: object


@dataclass
class File:
    """Binary body with explicit content type (used by swagger-ui serving)."""

    content: bytes
    content_type: str = "application/octet-stream"


@dataclass
class Redirect:
    url: str
    status_code: int = 302


@dataclass
class Response:
    """Full-control response: envelope data plus custom headers/status."""

    data: object
    status_code: int | None = None
    headers: dict[str, str] = field(default_factory=dict)
