"""Typed HTTP errors carrying their status code (the port's copy of the
part of gofr_tpu/http/errors.py that the engine raises).

Each error knows its HTTP status (``status_code``), so a transport maps
it without a table; ``retry_after`` is surfaced as a Retry-After header.
"""

from __future__ import annotations


class HTTPError(Exception):
    status_code: int = 500
    # seconds until a retry is worth attempting
    retry_after: float | None = None

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message or self.default_message()

    def default_message(self) -> str:
        return "internal server error"

    def __str__(self) -> str:
        return self.message


class TooManyRequests(HTTPError):
    """A concurrency cap is exceeded (errors.py:99): the request is
    well-formed but the caller is over its budget, retryable after
    ``retry_after`` seconds."""

    status_code = 429

    def __init__(self, message: str = "", retry_after: float | None = None):
        super().__init__(message)
        if retry_after is not None:
            self.retry_after = retry_after

    def default_message(self) -> str:
        return "too many requests"
