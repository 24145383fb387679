"""Request-lifetime plane: one absolute deadline carried end to end (the
port's own copy of gofr_tpu/deadline.py).

A client stamps an absolute wall-clock deadline on the request as
``X-Request-Deadline-Ms`` (unix epoch milliseconds). The HTTP edge
converts it ONCE to a *monotonic* deadline — immune to wall-clock steps —
in the per-request context (``App._materialize``) and sheds
already-expired work with 504; ``Context`` folds the remaining budget into
the engine timeout, and the App's handler budget is the tighter of
``REQUEST_TIMEOUT`` and that deadline.
"""

from __future__ import annotations

import time
from typing import Any

# absolute deadline, unix epoch milliseconds
DEADLINE_HEADER = "X-Request-Deadline-Ms"

# per-request context slot: monotonic seconds (time.monotonic() domain)
CTX_KEY = "deadline_at"


def parse_deadline_ms(value: Any) -> float | None:
    """Wire form (absolute epoch ms) -> monotonic deadline in seconds,
    or None when absent or malformed. A garbage deadline must never 500
    the request — it degrades to 'no deadline'."""
    if value is None or value == "":
        return None
    try:
        wall_remaining = float(value) / 1000.0 - time.time()
    except (TypeError, ValueError):
        return None
    return time.monotonic() + wall_remaining


def header_value(deadline_at: float) -> str:
    """Monotonic deadline -> the absolute epoch-ms wire form: what a caller
    stamps on an outgoing request so the next service inherits the
    budget."""
    wall = time.time() + (deadline_at - time.monotonic())
    return str(int(wall * 1000.0))


def set_deadline(ctx: dict, deadline_at: float | None) -> None:
    """Record a monotonic deadline on a per-request context dict."""
    if deadline_at is not None:
        ctx[CTX_KEY] = float(deadline_at)


def remaining(ctx: dict, now: float | None = None) -> float | None:
    """Remaining budget in seconds (can be <= 0 once expired); None when
    the request carries no deadline."""
    at = ctx.get(CTX_KEY)
    if at is None:
        return None
    return at - (time.monotonic() if now is None else now)
