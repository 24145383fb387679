"""The prefill planner and the length-bucket ladder (counterpart of
gofr_tpu/native/__init__.py ``PrefillPlan`` / ``_plan_prefill_py`` :107-136
and gofr_tpu/tpu/engine.py ``next_bucket`` / ``_pow2_buckets`` :76-90).

The JAX package builds the planner natively when it can and keeps this
Python body as its reference; the port runs the Python body alone (no
native build), with the same results.

EDF plus bucket affinity: the pending request with the earliest deadline
leads and sets the length bucket, and only prompts that fit that bucket join
its batch, so one long prompt never inflates the others' padding.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PrefillPlan:
    chosen: list[int]       # indices into the pending list, EDF order
    expired: list[int]      # past deadline OR longer than every bucket
    len_bucket: int
    batch_bucket: int


def plan_prefill(lens, deadlines_us, now_us: int, free_slots: int, max_batch: int,
                 len_buckets) -> PrefillPlan:
    """Plan one admission round over the pending prompts' lengths and
    deadlines (µs on the monotonic clock; ``<= 0`` means none): at most
    ``min(free_slots, max_batch)`` prompts, EDF order (ties by position),
    each no longer than the leader's bucket. A request past its deadline, or
    longer than the largest bucket, is ``expired``."""
    max_bucket = len_buckets[-1]
    expired = [i for i in range(len(lens))
               if 0 < deadlines_us[i] < now_us or lens[i] > max_bucket]
    dead = set(expired)
    valid = [i for i in range(len(lens)) if i not in dead]
    if not valid or free_slots <= 0 or max_batch <= 0:
        return PrefillPlan([], expired, 0, 0)
    valid.sort(key=lambda i: (deadlines_us[i] if deadlines_us[i] > 0 else 2**62, i))
    lead_len = lens[valid[0]]
    bucket = next((b for b in len_buckets if b >= lead_len), len_buckets[-1])
    cap = min(free_slots, max_batch)
    chosen = [i for i in valid if lens[i] <= bucket][:cap]
    bb = 1
    while bb < len(chosen):
        bb <<= 1
    return PrefillPlan(chosen, expired, bucket, min(bb, max_batch))


def next_bucket(n: int, buckets: list[int]) -> int:
    """Smallest bucket >= n (buckets sorted ascending); raises if too long."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"input length {n} exceeds max bucket {buckets[-1]}")


def pow2_buckets(lo: int, hi: int) -> list[int]:
    """lo, 2 lo, 4 lo, ... below hi, then hi: the engine's default prefill
    buckets (engine.py:995 with lo 16 and hi ``max_len``)."""
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return out
