"""Token-bucket rate limiting (QoS tier 1; the port's own copy of
gofr_tpu/qos/limiter.py).

A ``TokenBucket`` admits up to ``burst`` requests instantly and refills at
``rate`` tokens/second — the standard shape for per-route / per-API-key /
per-tenant request limits (the reference framework has no rate limiting at
all; its resilience surface stops at the inter-service circuit breaker).
``KeyedBuckets`` fans one (rate, burst) policy out
over an LRU-bounded key space so an attacker spraying unique API keys
cannot grow host memory without bound.

Thread-safety: transports call ``acquire`` from handler threads and the
asyncio loop concurrently; every bucket mutation happens under a lock.
Rejections return the *retry-after* hint (seconds until one token exists)
so the transport can emit ``Retry-After`` / RESOURCE_EXHAUSTED metadata
instead of a bare refusal.
"""

from __future__ import annotations

import collections
import threading
import time


class TokenBucket:
    """Classic token bucket: ``burst`` capacity, ``rate`` tokens/second.

    ``acquire(n)`` returns 0.0 when admitted, else the seconds until the
    bucket could admit ``n`` tokens (the Retry-After hint). ``rate <= 0``
    disables the limiter (always admits).
    """

    __slots__ = ("rate", "burst", "_tokens", "_stamp", "_lock")

    def __init__(self, rate: float, burst: float | None = None):
        self.rate = float(rate)
        self.burst = float(burst) if burst else max(1.0, self.rate)
        self._tokens = self.burst
        self._stamp = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self, n: float = 1.0, now: float | None = None) -> float:
        if self.rate <= 0:
            return 0.0
        if now is None:
            now = time.monotonic()
        with self._lock:
            self._tokens = min(self.burst, self._tokens + (now - self._stamp) * self.rate)
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate

    def peek(self, now: float | None = None) -> float:
        """Current token count (test/introspection hook; no side effects
        beyond the refill fold)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            self._tokens = min(self.burst, self._tokens + (now - self._stamp) * self.rate)
            self._stamp = now
            return self._tokens


class KeyedBuckets:
    """One (rate, burst) policy per dynamic key (route, API key, tenant).

    Keys are LRU-bounded at ``max_keys``: evicting a stale key merely
    resets its bucket to full burst, which only ever errs in the client's
    favor — bounded memory is worth that slack.
    """

    def __init__(self, rate: float, burst: float | None = None, max_keys: int = 4096):
        self.rate = float(rate)
        self.burst = burst
        self.max_keys = max_keys
        self._buckets: collections.OrderedDict[str, TokenBucket] = collections.OrderedDict()
        self._lock = threading.Lock()

    def acquire(self, key: str, n: float = 1.0) -> float:
        if self.rate <= 0:
            return 0.0
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = TokenBucket(self.rate, self.burst)
                self._buckets[key] = bucket
                while len(self._buckets) > self.max_keys:
                    self._buckets.popitem(last=False)
            else:
                self._buckets.move_to_end(key)
        return bucket.acquire(n)

    def __len__(self) -> int:
        return len(self._buckets)
