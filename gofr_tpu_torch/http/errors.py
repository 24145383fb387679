"""Typed HTTP errors carrying their status code (the port's own copy of
gofr_tpu/http/errors.py).

Parity with gofr `pkg/gofr/http/errors.go`: each error knows its HTTP status
(the responder consults ``status_code``); user code can raise these from any
handler (HTTP, gRPC, pub/sub, cron) and the transport maps them appropriately.
Any exception with a ``status_code`` attribute participates (the reference's
``statusCodeResponder`` interface).
"""

from __future__ import annotations


class HTTPError(Exception):
    status_code: int = 500
    # seconds until a retry is worth attempting; the responder surfaces it
    # as a Retry-After header (gRPC: retry-after trailing metadata)
    retry_after: float | None = None

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message or self.default_message()

    def default_message(self) -> str:
        return "internal server error"

    def __str__(self) -> str:
        return self.message


class EntityNotFound(HTTPError):
    status_code = 404

    def __init__(self, name: str = "", value: str = ""):
        self.name, self.value = name, value
        msg = f"No entity found with {name}: {value}" if name else "entity not found"
        super().__init__(msg)


class EntityAlreadyExists(HTTPError):
    status_code = 409

    def default_message(self) -> str:
        return "entity already exists"


class InvalidParam(HTTPError):
    status_code = 400

    def __init__(self, *params: str):
        self.params = list(params)
        n = len(self.params)
        super().__init__(f"'{n}' invalid parameter(s): {', '.join(self.params)}" if n else "invalid parameter")


class MissingParam(HTTPError):
    status_code = 400

    def __init__(self, *params: str):
        self.params = list(params)
        n = len(self.params)
        super().__init__(f"'{n}' missing parameter(s): {', '.join(self.params)}" if n else "missing parameter")


class InvalidRoute(HTTPError):
    status_code = 404

    def default_message(self) -> str:
        return "route not registered"


class RequestTimeout(HTTPError):
    status_code = 408

    def default_message(self) -> str:
        return "request timed out"


class PanicRecovery(HTTPError):
    status_code = 500

    def default_message(self) -> str:
        return "some unexpected error has occurred"


class Unauthorized(HTTPError):
    status_code = 401

    def default_message(self) -> str:
        return "unauthorized"


class Forbidden(HTTPError):
    status_code = 403

    def default_message(self) -> str:
        return "forbidden"


class TooManyRequests(HTTPError):
    """Rate limit / concurrency cap exceeded (QoS tier 1): the request is
    well-formed but the caller is over its budget — retryable after
    ``retry_after`` seconds."""

    status_code = 429

    def __init__(self, message: str = "", retry_after: float | None = None):
        super().__init__(message)
        if retry_after is not None:
            self.retry_after = retry_after

    def default_message(self) -> str:
        return "too many requests"


class ServiceUnavailable(HTTPError):
    status_code = 503

    def __init__(self, message: str = "", retry_after: float | None = None):
        super().__init__(message)
        if retry_after is not None:
            self.retry_after = retry_after

    def default_message(self) -> str:
        return "service unavailable"


class DeadlineExceeded(HTTPError):
    """The request's propagated deadline (``X-Request-Deadline-Ms`` or
    the gRPC deadline) is already unmeetable: either expired outright or
    the predicted queue wait exceeds the remaining budget. 504 — unlike
    408 (server-side timeout) and 503 (server refuses work it COULD do
    later), a 504 tells the caller its own clock ran out: retrying the
    same deadline is pointless. Not retryable, so no ``retry_after``."""

    status_code = 504

    def default_message(self) -> str:
        return "deadline exceeded"


def retry_after_hint(seconds: float) -> str:
    """One formatting site for every transport's retry hint (HTTP
    ``Retry-After`` header, gRPC ``retry-after`` trailing metadata):
    whole seconds, floored at 1 so a sub-second hint never reads as 0."""
    import math

    return str(max(1, math.ceil(float(seconds))))


def status_of(err: BaseException | None, method: str = "GET", has_result: bool = False) -> int:
    """Map (error, method) to an HTTP status (gofr `http/responder.go:52-66`)."""
    if err is None:
        if method == "POST":
            return 201
        if method == "DELETE":
            return 204
        return 200
    code = getattr(err, "status_code", None)
    if isinstance(code, int):
        return code
    if isinstance(err, TimeoutError):
        return 408
    return 500
